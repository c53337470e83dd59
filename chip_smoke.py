"""Chip smoke run of the PyTorch port (exllamav2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero). The model paths
of phases 5, 7, 9 and 11-14 run their decode steps and their prefills as
CUDA graphs (utils/graphs.py, the default on the card), and each also runs
once eagerly and must give bitwise the same tokens; a line per path prints
the captures and their ms, the replays (decode steps and prefills apart),
host ms a token or a dispatch (graphed and eager, one run), the device busy
time and the idle share; a measured round takes no capture. The prefill
lines (phases 5, 7, 13a, 13b, 14a) give each prefill call's host ms graphed
and eager, and its device ms (CUDA events around the graphed call), p50
TTFT and the idle share graphed and eager.
  1. build    compile csrc/*.cu with nvcc (one process per source, in
              parallel) and print the build time and ptxas report; count
              the HMMA instructions of kernels 2 and 3 (cuobjdump -sass);
  2. qmm      the fused dequant-matmul kernel against its plain version at the
              Llama-2-7B decode shapes, m in {1, 4, 8, 16, 32} (both
              templates: gemv below 8 rows, mma from 8, one or two m16
              tiles; the main path runs 1, 4 and 16), for EXL2 4-bit
              prescaled, EXL2 4-bit with qscale/smax, mixed 3/5/6-bit EXL2 and
              GPTQ 4-bit gs128 act-order; each m logs its template; times
              kernel, plain version and torch.matmul on the pre-dequantized
              bf16 weight (yardstick); then every m of 1-32 at 4096x4096
              for those kinds and for 2- and 8-bit EXL2 and GPTQ (every plane
              pair and meta kind), checked only;
  3. attn     the decode-attention kernel against its plain version at
              B in {1, 4}, 32/32 and 32/8 heads, D 128, S 2048, past_len in
              {0, 255, 1500}, plus softcap and a window of 512 (the attended
              rows start inside a split), and the grouped-query heads of
              GQA_HEADS (16/8 at D 256, 28/4, 64/8) at past_len 255 and
              1500; the template and split of each case (more than one at
              batch 1); SDPA as yardstick;
  4. load     Model.from_dir(tests/fixtures/trained_tiny) on the card, greedy
              tokens equal to the CPU run of the same checkpoint;
  5. 7B       random EXL2 4.0 bpw weights at Llama-2-7B geometry (32 layers,
              prescaled) built on the card; generate_greedy at batch 1 and 4,
              each with its own launch counts; decode-vs-prefill logits;
              decode tokens/s and a profile, both of generate_greedy itself;
  6. paged    the paged flash-decode kernel against its plain version on a
              24-page pool with shuffled block tables: B in {1, 16}, 32/32
              and 32/8 heads, D 128, valid lengths {1, 255, 256, 257, 1500}
              and a pad row on the null page, every cache kind (bf16, fp8,
              q8, q4, q6), plus softcap and window, and 28/4, 16/8 at D 256
              and 64/8 heads at every kind; each case logs the kernel's
              template and split (blocks of one thread-block cluster; more
              than one at batch 1); SDPA on the gathered, dequantized K/V
              as yardstick (gather not timed);
  7. serving  the serving path at 7B width: DynamicGenerator over a 20-page
              bf16 PagedKVCache runs 16 jobs (128-token prompts, 48 greedy new
              tokens, decode_burst 16) -- a warm round, then a measured round
              with its launch counts asserted, tokens/s, p50 TTFT and the
              device idle share; paged logits of one job teacher-forced
              through the linear-cache forward; a q4-cache round whose later
              jobs reuse the first job's prompt page; the prefill's matrix
              products by kernel name (bf16 on the tensor cores: no f32
              GEMM may appear);
  8. partials the W4A8 kernel and the GPTQ scales-on-partials kernel against
              their plain versions, m in {1, 4, 8, 16, 32}: W4A8 at the merged
              7B shapes (q|k|v 4096x12288, o 4096x4096, gate|up 4096x22016,
              down 11008x4096 padded to 11264 rows) for GPTQ 4-bit gs128 with
              compressed and with plain meta, with act-order, EXL2 4-bit gs32
              and mixed 8/3/5/6-bit EXL2 (each m logs the W4A8 template
              it took: dp4a below 8 rows, mma from 8); scales-on-partials
              at the unmerged shapes for GPTQ 4-bit gs128; and the fused
              kernel's merged (src_cols) meta kind on unprescaled EXL2
              q|k|v and gate|up;
  9. merged   the merged + W4A8 serving path at 7B width and full depth:
              random GPTQ 4-bit gs128 weights through
              DynamicGenerator(merged_weights=True, w4a8=True), the serving16
              round of phase 7 with its launch counts asserted; W4A8 logits
              of one job, teacher-forced: every W4A8 call against the
              kernel's plain version on the same activations, and the
              logits against the exact forward (both limits at 2 layers,
              the numbers also at 8 and 32; the logits of a plain-version
              pass printed beside them); the
              prefill's matrix products by kernel name, as in phase 7; a
              generate_greedy call under QMM_PARTIALS=1 on the unmerged GPTQ
              weights (the scales-on-partials kernel's path), then one
              profiled generate_greedy session whose partials_kernel events
              must equal the wrapper's calls in it (one kernel a linear;
              a group-sum or split-reduce kernel or more events fail at
              once, fewer mean lost records: up to 3 sessions); a
              merged-only EXL2 round whose greedy tokens must equal phase
              7's.
 10. tools    the ten feature probes (csrc/probe_features.cu) and the three
              roofline kernels of the perf_qmm tool (csrc/perf_qmm.cu: the
              streaming ceiling, group partials with bf16 and int8
              activations, the nibble split at its three tile variants)
              against their plain versions at the three 7B shapes, M = 8,
              4 bits, groups of 32 and 128 (int32 partials exact; f32 sums
              over groups in another order, 1e-4 of max |plain|; every K
              tile of the ceiling within 1e-5); timed with
              utils/timing.device_time beside the launch floor (add_ on a
              one-element tensor); each nibble and gp tiling logs its split
              (the cluster) and column block; gp at 1, 2 and 8 bits, both
              modes, gr 32 and 128, at 4096x4096, checked; the device
              kernels of 16 calls each of nibble_i8, gp (bf16, int8) and the
              bf16, int8 and int4 dot probes under the profiler (one kernel
              a call, nothing else: no reduce_splits); every variant and
              probe through the functions the entry points call, launch
              counts asserted; then
              `python -m exllamav2_tpu_torch.tools.perf_qmm w4a8_kernel` and
              `... probe_features int8_dot_batched` as a user starts them;
 11. constrained  the serving path at 7B width under constraints: a free
              round of 16 jobs, then 16 concurrent jobs under SelectFilter,
              PrefixFilter, banned strings from their own free text (with
              rewinds), token healing and post-sampling hooks, one token a
              dispatch with the launch counts asserted from the step count;
              a StreamingGenerator stream and four jobs under asyncio;
 12. spec     speculative decoding, CFG and LoRA on the serving path at 7B
              width and full depth (phase 7's weights), every round graphed
              and once eager with bitwise the same tokens: (1) the n-gram
              drafter at batch 1 (a 16-token pattern 8 times, 64 new tokens,
              4 drafts a round); (2) a draft model at batch 1 and 4 (32 new
              tokens): the 7B model itself with its own draft cache, and a
              2-layer random draft of another seed; each speculative round's
              tokens equal the plain round's up to a near-tie (at the first
              difference the plain round's teacher-forced top-2 gap is under
              0.02 of max |logit|), its launches of kernels 1 and 3 asserted
              from its rounds; tokens/s against the plain round, accepted
              drafts and host ms a round; (3) CFG: 4 jobs with 64-token
              negative prompts at scales 1.5 and 1.0 (1.0 gives the plain
              tokens up to a near-tie); (4) a rank-16 LoRA on q/k/v/o and
              gate/up/down, drawn on the card and loaded from a PEFT
              directory, attached to and detached from a live serving16
              generator, unmerged and merged (detached: the base tokens
              bitwise), adapted logits of a 2-layer cut against an f32
              plain forward on the CPU, and a weight swap under
              generate_greedy's step graphs against eager.
 13. archs    the architectures beyond Llama, each model path graphed and
              once eager (bitwise the same tokens) with its launch counts
              asserted: kernel 1's gated entry against its plain version at
              Mixtral's expert shapes (m 1, 4, 16; the flag on within 1e-4
              of max |plain|, off exact zeros); (a) Mixtral-8x7B at full
              width and depth (EXL2 4.0 bpw, prescaled, 8 experts, top 2):
              generate_greedy at batch 1 and 4, the experts switched on per
              layer and step, decode-vs-prefill, batch-1 tokens/s graphed
              and eager, device busy, kernel 1's ms a token against the
              routed-bytes floor, the gated decode's logits against the
              forced-dense formulation (< 0.02, argmax parts at near-ties
              only), a serving16 round (its prefill takes the capacity
              dispatch) with the dropped-route count; (b) Gemma-3-12B's
              text model at full width and depth (post-norms, QK-norm, the
              sliding layers' rope table, a tied bf16 head): batch-1
              greedy, decode-vs-prefill, tokens/s, a serving16 round; (c)
              Command R7B (4 layers: parallel blocks, a NoPE layer), GPT-2
              (2 layers: learned positions) and StarCoder-15B (2 layers:
              GPTBigCode, 48 query heads on one KV head, kernels 2 and 3 in
              one block of three m16 tiles) at published width: batch-1
              greedy and decode-vs-prefill (StarCoder's under DVP_LIMIT, and moved by
              less than DVP_WITNESS when kernel 2 is swapped for its plain
              version on the same weights); StarCoder also a serving16 round (kernel 3's
              launches asserted).
 14. vlm      the vision-language path: (a) Qwen2.5-VL-7B at full width
              and depth (EXL2 4.0 bpw LM with q/k/v biases, prescaled; the
              32-block tower in bf16, random from a seed; config.json and
              preprocessor_config.json as published, written to
              build/vlm_qwen25vl/): the tower's ms for a 1024x768 image
              (3,996 patches, 999 rows) and a 4-frame video; two tower
              blocks (6 windowed, 7 full) and the merger against the same
              cut in f32 on the CPU (< 0.02 of max |CPU|); a round of 8
              image jobs and 4 text jobs (32-token prompts, 48 greedy new
              tokens, decode_burst 16) graphed and once eager (bitwise the
              same tokens), its launches of kernels 1 and 3 asserted from
              its prefill forwards and step dispatches, tokens/s, p50 TTFT
              with the towers' share, device idle share; one image job's
              decode logits against one teacher-forced prefill with MRoPE
              rows over the whole sequence (< 0.02, also with f32
              probabilities), and the same decode at offset 0 failing that
              gate; batch-1 ms a token, device busy and kernel 1 against
              the linears' byte bound, the prompt's pages reused; CFG at
              1.0 giving the plain job's tokens up to a near-tie; (b)
              Gemma-3-12B's SigLIP tower (27 blocks, 896 px, 256 rows)
              over 4 of its 48 text layers and (c) Mistral-Small-3.1's
              pixtral tower with its patch merger (24 blocks) over 2 of its
              40 text layers: the tower's ms, a batch-1 image job graphed
              and once eager, decode against prefill (Gemma-3: the f32
              variant gated, as in phase 13).
 15. convert  the EXL2 converter: (a) kernel G1 (csrc/gptq.cu, the GPTQ row
              recursion of one group) against its plain version at the
              Llama-2-7B shapes (4096x4096, 4096x11008, 11008x4096,
              4096x32000), groups of 32 and 128 rows, 2-8 bits, on the
              factor of a Hessian of correlated activations: codes equal,
              dq and err within G1_TOL (bitwise logged), kernel and plain
              timed beside the bound; (b) random fp16 weights at
              Llama-2-7B width, 8 of 32 layers and the full head, written
              to build/convert_src/ and converted through `python -m
              exllamav2_tpu_torch.convert`'s entry with its defaults (4.0
              bpw, head 8 bits, 16 x 256 corpus rows, gs 32): seconds by
              stage and layer and a full-depth estimate, bits per weight
              from total_bits within the budget, G1 launches equal to the
              groups quantized, GPTQ below RTN on every linear of layer 0;
              (c) the output served: generate_greedy at batch 1 graphed
              (launch counts asserted, one a segment) and eager (bitwise
              the same tokens), kernel 1 held on every converted segment
              shape at m 1 and 16, decode vs prefill; (d)
              tests/fixtures/trained_tiny converted on the card (4.0 bpw,
              head 6 bits): perplexity dense and converted, greedy tokens
              equal to the CPU's on the card's checkpoint.
 16. cli      the tools around the model on phase 15's outputs (the
              8-layer 3.9947-bpw conversion in build/convert_out and its
              fp16 source in build/convert_src; the phase raises if either
              is missing): (a) model_init.init(-m convert_out -l 2048,
              max_batch_size 16): torch.cuda.memory_allocated of the model
              and of the cache beside cli.fit_hbm's prediction for the same
              directory, bits and context, and their ratios, the load's
              peak, and the loader's plane words packed on the card equal
              to the CPU's at 1-8 bits; (b) the
              websocket server's dispatch over in-process connections: 8
              concurrent greedy requests (128-byte prompts, 64 new tokens)
              with echo, estimate_token and lefttrim_token beside them and
              an extra request that a stop ends after 8 tokens (a warm
              round, then the measured one, graphed): chunks joined equal
              each full text, each text equals its prompt run alone through
              generator.generate (or parts at a near-tie), the stopped job
              cancelled and every page back in the pool, launches of
              kernels 1 and 3 counted; tokens/s, requests/s, p50 time to
              first chunk; a graphed round with no stop, its texts
              bitwise generate()'s of the same 8 prompts as one batch; the
              measured round, stop included, through an eager generator and
              the first prompt alone under held_kernels (kernel 1 at m 1,
              8 and 16 on every segment shape, kernel 3 at batch 1, 8 and
              16: every bucket of the measured round);
              the byte tokenizer's decode is replaced by one that names
              every id; (c) `cli.test_inference -ed random -er 4 -el 512 -p
              -t 64 -ps --greedy`: a finite perplexity; (d)
              `cli.estimate_kld` and `cli.model_diff` with A the fp16
              source, B the conversion (A against A: KLD <= 1e-6, top-1
              100 %); (e) fpxify of the source at e4m3, e3m2, e2m1: KLD
              against it rising as bits fall; (f) rank_reduce_linear on
              layer 0's gate, up and down: fraction 1.0 within 1e-3 of max
              |w|, the error and seconds at 0.5.
 17. tp       multi-GPU serving on the one card: (a) kernels 2 and 3 at 48
              and 22 query heads on one KV head, D 128 (StarCoder-15B's
              and StarCoderBase-3B's multi-query attention: the mma
              templates, all heads in one block), against their plain
              versions (kernel 3 at every
              cache kind), timed beside SDPA and the bound; (b) two
              tensor-parallel ranks (processes started by
              exllamav2_tpu_torch/parallel/launch.py, both on cuda:0, gloo
              between them through the host: not NVLink) serving 4 greedy
              jobs of 32 tokens at Llama-2-7B width and 8 layers, 4-bit:
              round 0 with kernels 1 and 3 held against their plain
              versions on each rank's own inputs at its shard's widths
              (N / 2, 16 KV heads), the ranks' tokens and logits bitwise
              equal, and within TP_LOGITS_TOL of one process's on the same
              weights up to each job's first differing token, which must
              fall on a near-tie (TIE_GAP); round 1's launch counts and ms
              a decode step; (c) the same over two expert-parallel ranks at
              Mixtral-8x7B's width, 2 layers (4 whole experts a rank, the
              gated kernel 1 held with its flag set and clear); (d) DataParallelGenerator(dp=2, tp=1) with
              both replicas on the card: the plain generator's texts (each
              replica's batch served alone), both replicas serving; (e)
              the bytes a rank holds at tp 2 against one process's,
              Llama-2-7B (everything splits) and StarCoder-15B (the
              fallback: one KV head keeps attention and its cache whole),
              from 2-layer cuts at full depth.
 18. scripts  the training path and the reference's remaining scripts as
              the port's twins (exllamav2_tpu_torch/cli/): (a) the trainer
              (cli/train_fixture.py) at step 0 on the card against the CPU
              twin on the same batch and init (loss within TRAIN_LOSS_TOL,
              every gradient within TRAIN_GRAD_TOL of its max; the dense
              products' gradient through ops/qmm.BF16Dot, TRAIN_DOTS calls
              a forward; no hand kernel launched), then its defaults (1,200
              steps, batch 8, seed 7): every loss finite, the last under
              TRAIN_FINAL_LOSS, ms a step and tokens trained a second,
              exported to build/trained_tiny; (b) eval_trained on that
              export and on tests/fixtures/trained_tiny, whose completions,
              picks and job tokens equal the CPU twin's; (c)
              convert_serve_check: converted on the card (G1), served greedy
              on the card over a q4 cache with its logits, replayed forced
              on the CPU, checked (tol 0.08); (d) quality_eval on the card
              (kernels 1, 2, 4 and G1 launched); (e) bench_serving and
              decomp_flagship at their 7B defaults; (f) the sixteen example
              twins on the card (trained_tiny; a 4,096-position random EXL2
              model for inference_dedup; a random qwen2 VLM with a peaked
              head for the multimodal three), each but
              inference_speculative (dense linears, verify steps through
              the gathered pool) launching kernel 1 or 3; the greedy
              ones' job tokens equal the CPU's, or, run again
              with every step's logits, part at a near-tie (TIE_GAP) on the
              card's logits. Launch counts of kernels 1-4 and G1 by step
              go into the kernels line (`scripts_*`).
The last lines are one JSON line of the kernels, the card's name and power
limit, and {"ok": true, "device": {...}}. Details go to
build/chip_smoke.json. `python3 chip_smoke.py qmm` runs phases 1 and 2 and
phase 8's merged-meta (src_cols) cases of the fused kernel (a quick check of
csrc/qmm.cu), `python3 chip_smoke.py attn` phases 1 and 3 (the
decode-attention kernel), `python3 chip_smoke.py
paged` phases 1 and 6 (the paged kernel), `python3 chip_smoke.py w4a8` phases
1 and 8 (the W4A8, scales-on-partials and merged-meta kernels),
`python3 chip_smoke.py merged` phases 1, 7 and 9 (the serving rounds),
`python3 chip_smoke.py tools` phases 1 and 10, `python3 chip_smoke.py
constrained` phases 1 and 11, `python3 chip_smoke.py spec` phases 1 and 12,
`python3 chip_smoke.py archs` phases 1 and 13 (`python3 chip_smoke.py
dvp-seeds` phase 1 and StarCoder's decode-vs-prefill readings at six
seeds, which set DVP_LIMIT and DVP_WITNESS), `python3 chip_smoke.py vlm`
phases 1 and 14, `python3 chip_smoke.py convert` phases 1 and 15,
`python3 chip_smoke.py cli` phases 1, 15 and 16, `python3 chip_smoke.py
tp` phases 1 and 17 (`chip_smoke.py tp-rank <mode> <device>` is one of
phase 17's ranks), `python3 chip_smoke.py scripts` phases 1 and 18,
`python3 chip_smoke.py gqa-paged` builds csrc/paged_attn.cu alone and times
kernel 3 at 48/1 and 28/4 heads over every kind at batch 1 and 16 (run from
another checkout, it times that checkout's kernel: the comparison in one
call).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
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
# the merged serving linears of one layer: q|k|v, o, gate|up, down
MERGED_SHAPES = [(HIDDEN, 3 * HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, 2 * INTER),
                 (INTER, HIDDEN)]
QMM_ROWS = (1, 4, 8, 16, 32)   # one m per row tile MT of the qmm kernels
QMM_TOL = 1e-4          # max |kernel - plain| <= QMM_TOL * max |plain|
ATTN_TOL = 1e-4         # max |kernel - plain| <= ATTN_TOL * max |v|
# kernel 3 on a served model's own decode inputs (phase 14): kernel and
# plain version round p to bf16 at the same points, but their f32 scores
# differ in summation order, so a probability near a rounding boundary can
# round either way; one such step moves the output by up to 2^-8 of max |v|
# (each is as far from an f64 evaluation with those rounding points, a
# peaked softmax leaves few rows to average the step away)
ATTN_PATH_TOL = 2.0 ** -8
# W4A8 through a model, both limits at the depth of the reference's model
# test (2 layers): a sum-order ulp can flip the int8 rounding of a later
# activation, so two W4A8 runs drift apart with depth (the script prints the
# numbers at 8 and 32 layers too).
W4A8_LOGITS_TOL = 0.05  # vs the exact forward: mean |diff| / mean |exact|
# kernel vs plain version on the same activations, every W4A8 call of a
# 2-layer teacher-forced pass: max |diff| / max |plain| (f32 sum order; the
# logits of two whole passes part after an int8 rounding flips, and are
# printed beside it)
W4A8_PLAIN_TOL = 1e-3
# scales-on-partials against the fused kernel through a 2-layer model (the
# fused kernel rounds each weight to bf16: 1.4e-3 of max |y| on one linear)
PARTIALS_LOGITS_TOL = 0.02
MERGED_LOGITS_TOL = 1e-3    # max |merged - unmerged| / max |unmerged|
L2_BYTES = 50 << 20
# the serving leg of the JAX package's bench.py (serving16)
SERVE_JOBS, SERVE_PROMPT, SERVE_NEW, SERVE_PAGES = 16, 128, 48, 20
# bytes of one cached K (or V) row of one KV head at D = 128, scales included
def row_bytes(kind: str, d: int = 128) -> int:
    """Bytes of one cache row of a paged kind: the data and its bf16 group
    scales (one per 32 elements)."""
    return {"bf16": 2 * d, "fp8": d, "q8": d + d // 16,
            "q4": d // 2 + d // 16}[kind]
PEAK_BF16 = 989e12      # dense bf16 operations/s of the H100 SXM


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
    """Device ms per call, cycling through fns: the slope of
    utils/timing.device_time between CUDA graphs of iters // 4 and iters
    calls, so every `ms` of the kernels line is taken by one method."""
    from exllamav2_tpu_torch.utils.timing import device_time
    step = itertools.count()
    like = torch.empty(0, device="cuda")
    return device_time(lambda _: fns[next(step) % len(fns)](), like,
                       iters=iters) * 1e3


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


def graph_counts(owner, since=None) -> dict:
    """Captures, their ms (warm-up and capture) and replays of the step
    graphs of a Model or DynamicGenerator, its decode steps' and (prefill_)
    its prefills', less those of `since` (an earlier result of this
    function)."""
    out = {}
    for pre, runner in (("", owner.step_graphs),
                        ("prefill_", owner.prefill_graphs)):
        out[pre + "captures"] = sum(runner.captures.values()) \
            if runner else 0
        out[pre + "capture_ms"] = sum(runner.capture_ms.values()) \
            if runner else 0.0
        out[pre + "replays"] = sum(runner.replays.values()) if runner else 0
    if since:
        out = {k: v - since[k] for k, v in out.items()}
    return out


def no_captures(tag, g) -> None:
    """A measured round (graph_counts over it) captured nothing."""
    if g["captures"] or g["prefill_captures"]:
        raise AssertionError(f"{tag}: the measured round captured "
                             f"{g['captures']} step and "
                             f"{g['prefill_captures']} prefill graphs")


def prefill_keys(tag, owner) -> dict:
    """Each prefill key of `owner` with its captures, capture ms (warm-up,
    capture, first replay) and replays, logged."""
    runner = owner.prefill_graphs
    keys = {str(k): {"captures": runner.captures[k],
                     "capture_ms": runner.capture_ms[k],
                     "replays": runner.replays[k]}
            for k in runner.captures} if runner else {}
    for k, v in keys.items():
        log(f"[{tag}] prefill key {k}: {v['captures']} captures in "
            f"{v['capture_ms']:.1f} ms, {v['replays']} replays")
    return keys


class PrefillTimer:
    """Times every prefill forward of a DynamicGenerator (its
    _prefill_forward): host ms from the call to its last kernel's end (a
    synchronize before and after), and device ms by CUDA events around the
    call (on a replay the graph's device time; eager, the span of its
    launches)."""

    def __init__(self, gen):
        self.gen, self.host_ms, self.device_ms = gen, [], []
        self.inner = gen._prefill_forward
        self.wrapped = "_prefill_forward" in vars(gen)    # by logged()

    def __enter__(self):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            s.record()
            out = self.inner(*a, **kw)
            e.record()
            torch.cuda.synchronize()
            self.host_ms.append((time.perf_counter() - t) * 1e3)
            self.device_ms.append(s.elapsed_time(e))
            return out
        self.gen._prefill_forward = timed
        return self

    def __exit__(self, *exc):
        if self.wrapped:
            self.gen._prefill_forward = self.inner
        else:
            del self.gen._prefill_forward
        self.gen = self.inner = None          # hold the generator no longer

    def summary(self) -> dict:
        return {"calls": len(self.host_ms), "host_ms": sum(self.host_ms),
                "device_ms": sum(self.device_ms)}


def prefill_line(tag, graphed: dict, eager_: dict, ttft=None, idle=None,
                 delivered=None):
    """One line of a path's prefills: host ms graphed and eager, device ms
    of the graphed calls; p50 TTFT, the idle share and the p50 delivery of
    the first token, graphed and eager."""
    line = (f"[{tag}] prefill: {graphed['calls']} calls, host "
            f"{graphed['host_ms']:.1f} ms graphed against "
            f"{eager_['host_ms']:.1f} eager ({eager_['calls']} calls), device "
            f"{graphed['device_ms']:.1f} ms graphed (host share "
            f"{1 - graphed['device_ms'] / max(graphed['host_ms'], 1e-9):.1%})")
    if ttft is not None:
        line += f"; p50 TTFT {ttft[0]:.1f} ms graphed, {ttft[1]:.1f} eager"
    if idle is not None:
        line += f"; idle share {idle[0]:.1%} graphed, {idle[1]:.1%} eager"
    if delivered is not None:
        line += (f"; first token delivered at p50 {delivered[0]:.1f} ms "
                 f"graphed, {delivered[1]:.1f} eager")
    log(line)
    return {"graphed": graphed, "eager": eager_, "p50_ttft_ms": ttft,
            "idle_share": idle, "p50_delivered_ms": delivered}


def eager(model, fn):
    """fn() with the model's forwards eager (model.graphs off)."""
    model.graphs = False
    try:
        return fn()
    finally:
        model.graphs = True


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
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": dt, "ptxas": reports, "hmma": hmma_counts()}


def hmma_counts() -> dict:
    """HMMA (bf16 tensor-core) instructions in the SASS of kernels 2 and 3,
    by cuobjdump: the mma templates' scores and P.V."""
    from exllamav2_tpu_torch import _build
    tool = os.path.join(os.path.dirname(os.path.dirname(_build._nvcc())),
                        "bin", "cuobjdump")
    out = {}
    for name in ("decode_attn", "paged_attn"):
        sass = subprocess.run([tool, "-sass", _build._target(name)[1]],
                              capture_output=True, text=True, check=True)
        out[name] = sum("HMMA" in ln for ln in sass.stdout.splitlines())
        log(f"[build] {name}: {out[name]} HMMA instructions (cuobjdump -sass)")
        if not out[name]:
            raise AssertionError(f"{name}: no HMMA in its SASS")
    return out


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
    if kind in ("gptq_4b_gs128", "gptq_4b_gs128_actorder"):
        lin = random_gptq_linear(gen, k, n, bits=4, group_rows=128,
                                 device=dev)
        if kind == "gptq_4b_gs128":
            return lin
        perm = torch.randperm(k, generator=gen, device=dev).to(torch.int32)
        return QuantLinear(list(lin.segments), perm, None, k=k, n=n,
                           n_orig=n)
    raise ValueError(kind)


def make_w4a8_linear(kind: str, k: int, n: int, gen, dev):
    """A linear flagged for the W4A8 kernel (every segment act8)."""
    from exllamav2_tpu_torch.ops.dequant import enable_w4a8_linear
    from exllamav2_tpu_torch.quant.qtensor import QuantLinear
    from exllamav2_tpu_torch.utils.testing import random_quant_linear
    if kind == "gptq_gs128_bf16meta":        # the flagship: compressed meta
        return enable_w4a8_linear(make_linear("gptq_4b_gs128", k, n, gen,
                                              dev))
    if kind == "gptq_gs128_actorder":
        return enable_w4a8_linear(make_linear("gptq_4b_gs128_actorder", k, n,
                                              gen, dev))
    if kind == "gptq_gs128_f32meta":         # f32 scale, int32 zero, no pad
        lin = make_linear("gptq_4b_gs128", k, n, gen, dev)
        return QuantLinear([s.replace(act8=True) for s in lin.segments],
                           None, None, k=k, n=n, n_orig=n)
    if kind == "exl2_4b_gs32":
        return enable_w4a8_linear(make_linear("exl2_4b_qscale", k, n, gen,
                                              dev))
    if kind == "exl2_mixed_8356":
        nsb = k // 256
        rows = [(nsb // 4 + (i < nsb % 4)) * 256 for i in range(4)]
        segs = [random_quant_linear(gen, r, n, bits=b, device=dev)
                .segments[0] for r, b in zip(rows, (8, 3, 5, 6))]
        return enable_w4a8_linear(
            QuantLinear(segs, None, None, k=k, n=n, n_orig=n))
    raise ValueError(kind)


def make_merged_linear(k: int, widths, gen, dev):
    """Unprescaled EXL2 4-bit sources merged by columns: the fused kernel's
    src_cols meta kind."""
    from exllamav2_tpu_torch.ops.dequant import merge_linears
    from exllamav2_tpu_torch.utils.testing import random_quant_linear
    lin = merge_linears([random_quant_linear(gen, k, w, bits=4, device=dev)
                         for w in widths])
    assert lin.segments[0].src_cols and lin.segments[0].scale_f is None
    return lin


def segment_meta(seg) -> list:
    """The group-meta buffers the kernel that serves `seg` reads."""
    from exllamav2_tpu_torch.ops.qmm import _w4a8_meta
    from exllamav2_tpu_torch.quant.qtensor import GptqSegment
    if seg.act8:
        _, scale, zero = _w4a8_meta(seg)
        return [scale] if zero is scale else [scale, zero]
    if isinstance(seg, GptqSegment):
        return [seg.scale, seg.zero]
    if seg.scale_f is not None:
        return [seg.scale_f]
    return [seg.qscale, seg.smax]


def linear_bytes(lin, m: int) -> int:
    """Bytes the kernels must move for one linear: planes, the meta they
    read (f32/int32, bf16 or uint8 + f32, by kind), x in (f32 for a W4A8
    segment, else bf16) and out (f32) once."""
    total = 0
    for seg in lin.segments:
        total += sum(p.numel() * 4 for p in seg.planes)
        total += sum(t.numel() * t.element_size() for t in segment_meta(seg))
        total += m * seg.rows_pad * (4 if seg.act8 else 2)
    return total + m * lin.n * 4


def segment_inputs(lin, x):
    """(activation slice, segment) pairs as qmm() feeds the kernels: the
    act-order gather, zero-padded K, f32 for a W4A8 segment, else bf16."""
    xg = x if lin.perm is None else x[:, lin.perm.long()]
    out, row = [], 0
    for seg in lin.segments:
        xs = xg[:, row:row + seg.rows].to(
            torch.float32 if seg.act8 else torch.bfloat16)
        xs = torch.nn.functional.pad(xs, (0, seg.rows_pad - seg.rows))
        out.append((xs.contiguous(), seg))
        row += seg.rows
    return out


def kernel_template(m: int, seg) -> str:
    """The template of the kernel that serves `seg` at m rows: csrc/qmm_w4a8.cu
    (mma / dp4a) for a W4A8 segment, else csrc/qmm.cu (gemv / mma)."""
    from exllamav2_tpu_torch.ops.qmm import qmm_template, w4a8_template
    if seg.act8:
        return w4a8_template(m, seg.group_rows, seg.planes[0].shape[1])
    return qmm_template(m)


def check_and_time(tag, make, k, n, kernel, plain, gen, dev, rate, rows):
    """One linear kind at one shape: `kernel` against `plain` on every
    segment at every row tile (raises beyond QMM_TOL), then the times of the
    kernel (weights cycled past the L2), the plain version and torch.matmul
    on the pre-dequantized bf16 weight, and the byte bound. Appends to
    `rows`; returns the worst absolute error."""
    from exllamav2_tpu_torch.ops.dequant import dequant_linear
    one = make()
    wbytes = linear_bytes(one, 0)
    copies = [one] + [make() for _ in
                      range(max(1, -(-2 * L2_BYTES // wbytes)) - 1)]
    wdense = [dequant_linear(c, torch.bfloat16, original_order=False)
              for c in copies[:max(1, -(-2 * L2_BYTES // (k * n * 2)))]]
    worst = 0.0
    for m in QMM_ROWS:
        x = torch.randn((m, k), generator=gen, device=dev)
        xb = x.to(torch.bfloat16)
        ins = [segment_inputs(c, x) for c in copies]
        err, scale = 0.0, 0.0
        for xs, seg in ins[0]:
            got = kernel(xs, seg)
            ref = plain(xs, seg)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), (tag, k, n, m)
            err = max(err, (got - ref).abs().max().item())
            scale = max(scale, ref.abs().max().item())
        rel = err / scale
        if rel > QMM_TOL:
            raise AssertionError(
                f"{tag} {k}x{n} m={m}: rel err {rel:.3g}")
        worst = max(worst, err)

        def kernel_call(pairs):
            return lambda: [kernel(xs, s) for xs, s in pairs]

        ms = graph_ms([kernel_call(p) for p in ins], 40)
        plain_ms = eager_ms(lambda: [plain(xs, s) for xs, s in ins[0]], 3)
        lib_ms = graph_ms([(lambda w=w: torch.matmul(xb, w))
                           for w in wdense], 40)
        nbytes = linear_bytes(one, m)
        bound = nbytes / rate * 1e3
        # the template of each segment's kernel (csrc/qmm_w4a8.cu: mma or
        # dp4a; csrc/qmm.cu: gemv or mma); none for scales-on-partials
        tmpl = "" if kernel.__name__.startswith("partials") else "/".join(
            sorted({kernel_template(m, s) for s in one.segments}))
        rows.append(dict(kind=tag, k=k, n=n, m=m, max_abs_err=err,
                         rel_err=rel, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bytes=nbytes, bound_ms=bound,
                         template=tmpl or None))
        log(f"[{tag.split(':')[0]}] {tag.split(':')[-1]:24s} "
            f"{k:5d}x{n:5d} m={m:2d}{' ' + tmpl if tmpl else ''} "
            f"err={err:.2e} rel={rel:.1e} kernel={ms * 1e3:8.1f}us "
            f"plain={plain_ms * 1e3:9.1f}us lib={lib_ms * 1e3:7.1f}us "
            f"bound={bound * 1e3:6.1f}us "
            f"({bound / ms * 100:4.1f}% of roofline, lib/kernel "
            f"{lib_ms / ms:4.2f}x)")
    del copies, wdense, ins
    torch.cuda.empty_cache()
    return worst


def phase_qmm(dev, rate):
    from exllamav2_tpu_torch.ops import qmm as Q
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows, worst = [], 0.0
    kinds = ["exl2_4b_prescaled", "exl2_4b_qscale", "exl2_mixed_356",
             "gptq_4b_gs128_actorder"]
    for kind in kinds:
        for (k, n) in SHAPES:
            worst = max(worst, check_and_time(
                "qmm:" + kind, lambda: make_linear(kind, k, n, gen, dev),
                k, n, Q.fused_segment_matmul, Q.qmm_plain, gen, dev, rate,
                rows))
    worst = max(worst, qmm_every_m(dev, gen))
    for r in rows:
        r["kind"] = r["kind"].split(":")[1]
    return rows, worst


def qmm_every_m(dev, gen) -> float:
    """The fused kernel against its plain version at every m of 1-32 at
    4096x4096, for every plane pair and meta kind (checked, not timed);
    returns the worst absolute error."""
    from exllamav2_tpu_torch.ops import qmm as Q
    from exllamav2_tpu_torch.ops.dequant import precompute_scales_linear
    from exllamav2_tpu_torch.quant.qtensor import QuantLinear
    from exllamav2_tpu_torch.utils.testing import (
        random_gptq_linear, random_quant_linear)
    k = n = HIDDEN
    lins = {kind: make_linear(kind, k, n, gen, dev) for kind in
            ("exl2_4b_prescaled", "exl2_4b_qscale", "exl2_mixed_356",
             "gptq_4b_gs128_actorder")}
    half = [random_quant_linear(gen, k // 2, n, bits=b, device=dev)
            .segments[0] for b in (2, 8)]
    lins["exl2_mixed_28"] = precompute_scales_linear(
        QuantLinear(half, None, None, k=k, n=n, n_orig=n))
    lins["exl2_mixed_28_qscale"] = QuantLinear(half, None, None, k=k, n=n,
                                               n_orig=n)
    for b in (2, 3, 8):
        lins[f"gptq_{b}b_gs32"] = random_gptq_linear(
            gen, k, n, bits=b, group_rows=32, device=dev)
    worst, rel_worst = 0.0, 0.0
    for kind, lin in lins.items():
        for m in range(1, 33):
            x = torch.randn((m, k), generator=gen, device=dev)
            for xs, seg in segment_inputs(lin, x):
                got = Q.fused_segment_matmul(xs, seg)
                ref = Q.qmm_plain(xs, seg)
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                if not (torch.isfinite(got).all() and rel <= QMM_TOL):
                    raise AssertionError(f"qmm {kind} m={m}: rel err {rel}")
                worst, rel_worst = max(worst, err), max(rel_worst, rel)
    torch.cuda.synchronize()
    log(f"[qmm] every m of 1-32 at {k}x{n}, {len(lins)} kinds (plane pairs "
        f"2, 2+1, 4, 4+1, 4+2, 8; meta scale_f, qscale, GPTQ): worst rel err "
        f"{rel_worst:.1e} (limit {QMM_TOL:g})")
    del lins
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------- phase 3

def attn_cases():
    # past_len 0 leaves every split but the first empty; with a window of
    # 512 at past_len 1500 the attended rows start inside a split
    cases = [(b, hq, hkv, p, 0.0, 0) for b in (1, 4)
             for hq, hkv in ((32, 32), (32, 8)) for p in (0, 255, 1500)]
    cases += [(1, 32, 8, 1500, 30.0, 0), (1, 32, 8, 1500, 0.0, 512),
              (1, 32, 32, 1500, 0.0, 512)]
    # grouped-query heads of the models served: Gemma-3-12B (16/8 at
    # D = 256), Qwen2.5-VL-7B (28/4), Llama-3-70B (64/8)
    return cases + [(b, hq, hkv, p, 0.0, 0, d) for b in (1, 4)
                    for hq, hkv, d in GQA_HEADS for p in (255, 1500)]


# (query heads, KV heads, head_dim) of the GQA cases of phases 3 and 6
GQA_HEADS = ((16, 8, 256), (28, 4, 128), (64, 8, 128))


def template_name(mt: int) -> str:
    return f"mma x{mt}" if mt else "cuda-core"


def phase_attn(dev, rate, cases=None, tag="attn"):
    from exllamav2_tpu_torch.models.model import _limit_bucket
    from exllamav2_tpu_torch.ops import decode_attn as A
    import torch.nn.functional as Fn
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    s_max, nl = 2048, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0.0
    for b, hq, hkv, past, cap, win, *rest in cases or attn_cases():
        d = rest[0] if rest else 128
        shape = (nl, b, hkv, s_max, d)
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        qs = [torch.randn((b, hq, d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(nl)]
        limit = _limit_bucket(past + 1, s_max)
        scale = d ** -0.5
        vmax = v[3].float().abs().max().item()
        ref = A.decode_attention_plain(qs[3], k, v, 3, past, limit, scale,
                                       cap, win)

        # the grid: every (batch, KV head, head block) over the splits
        _, blocks, mt, splits, per = A.grid(b, hkv, hq // hkv, limit, sms)
        got = A.decode_attention(qs[3], k, v, 3, past, limit, scale, cap,
                                 win)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not torch.isfinite(got).all() or err > ATTN_TOL * vmax:
            raise AssertionError(
                f"attn b={b} {hq}/{hkv} d={d} past={past} cap={cap} "
                f"win={win} {template_name(mt)} splits={splits}: err "
                f"{err:.3g}")
        ms = graph_ms([(lambda l=l: A.decode_attention(
            qs[l], k, v, l, past, limit, scale, cap, win))
            for l in range(nl)], 64)
        if b == 1 and splits < 2:
            raise AssertionError(f"attn b=1 {hq}/{hkv} limit={limit}: one "
                                 "split")
        worst = max(worst, err)
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
        rows.append(dict(b=b, hq=hq, hkv=hkv, d=d, past_len=past,
                         limit=limit, splits=splits, rows_per_split=per,
                         blocks=blocks, template=template_name(mt),
                         softcap=cap, window=win, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                         bound_ms=bound))
        lib_s = f"{lib_ms * 1e3:7.1f}us" if lib_ms is not None else "   n/a"
        log(f"[{tag}] b={b} {hq:2d}/{hkv:2d} d={d} past={past:4d} "
            f"limit={limit:4d} {template_name(mt)} blocks={blocks} "
            f"splits={splits:2d}x{per:4d} cap={cap:4.1f} win={win:3d} "
            f"err={err:.2e} kernel={ms * 1e3:7.1f}us "
            f"plain={plain_ms * 1e3:8.1f}us sdpa={lib_s} "
            f"bound={bound * 1e3:5.1f}us ({bound / ms * 100:4.1f}% of "
            f"roofline)")
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
    for prompt in (prompt1, prompt4):
        for _ in range(2):      # warm-up: a prefill key captures at its 2nd
            model.generate_greedy(prompt, 2)
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
    launches, seqs, graphs = {}, {}, {}
    for name, (prompt, want) in paths.items():
        Q.LAUNCHES["qmm"] = 0
        A.LAUNCHES["decode_attn"] = 0
        g0 = graph_counts(model)
        seq = model.generate_greedy(prompt, new)
        got = {"qmm": Q.LAUNCHES["qmm"],
               "decode_attn": A.LAUNCHES["decode_attn"]}
        graphs[name] = graph_counts(model, g0)
        log(f"[7b] {name}: launches {got} (expected {want}); step graphs "
            f"{graphs[name]}")
        if got != want:
            raise AssertionError(f"{name} launch counts {got} != {want}")
        b = prompt.shape[0]
        if seq.shape != (b, 16 + new) or seq.min() < 0 or seq.max() >= VOCAB:
            raise AssertionError(f"{name}: bad generation {seq.shape}")
        if (graphs[name]["replays"] != steps
                or graphs[name]["prefill_replays"] != 1):
            raise AssertionError(f"{name}: {graphs[name]} for {steps} steps"
                                 " and a prefill")
        # the same path eager: bitwise the same tokens
        seq_e = eager(model, lambda: model.generate_greedy(prompt, new))
        log(f"[7b] {name}: graphed tokens equal the eager path's: "
            f"{np.array_equal(seq, seq_e)}")
        if not np.array_equal(seq, seq_e):
            raise AssertionError(f"{name}: graphed {seq.tolist()} != eager "
                                 f"{seq_e.tolist()}")
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

    # both calls replay the prefill key of the b1 path (the same cache of
    # generate_greedy, the same 16 rows): nothing is captured
    g0 = graph_counts(model)
    t_pre = min(wall(1) for _ in range(3))
    t_all = min(wall(1 + n_dec) for _ in range(2))
    no_captures("7b timed calls", graph_counts(model, g0))
    ms_tok = (t_all - t_pre) / n_dec * 1e3
    tps = 1e3 / ms_tok
    log(f"[7b] decode batch 1: {tps:.2f} tokens/s ({ms_tok:.3f} ms/token "
        f"over {n_dec} tokens of generate_greedy; prefill-only call "
        f"{t_pre * 1e3:.1f} ms)")
    # the eager step and prefill in the same run, on half the tokens
    t_pre_e = eager(model, lambda: min(wall(1) for _ in range(2)))
    t_all_e = eager(model, lambda: wall(1 + n_dec // 2))
    ms_tok_e = (t_all_e - t_pre_e) / (n_dec // 2) * 1e3
    # the prefill alone: the 16 rows' forward with its graph (CUDA events
    # around the replay: its device time) and eagerly
    cache = model._greedy_cache(1, 256)

    def prefill_ms():
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        s.record()
        model.forward(prompt1, cache, 0, last_token_only=True)
        e.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, s.elapsed_time(e)
    pre_g = min(prefill_ms() for _ in range(5))
    pre_e = eager(model, lambda: min(prefill_ms() for _ in range(3)))
    no_captures("7b prefill", graph_counts(model, g0))
    pkeys = prefill_keys("7b", model)
    log(f"[7b] prefill-only call (16 rows, batch 1): {t_pre * 1e3:.1f} ms "
        f"graphed, {t_pre_e * 1e3:.1f} eager (same run); its forward alone "
        f"{pre_g[0]:.2f} ms graphed (device {pre_g[1]:.2f}), {pre_e[0]:.2f} "
        f"eager (device span {pre_e[1]:.2f})")

    # --- where a decode token's device time goes (kernels only)
    prof = profile_decode(model, prompt1)
    prof_e = eager(model, lambda: profile_decode(model, prompt1))
    busy, busy_e = prof["device_ms_per_token"], prof_e["device_ms_per_token"]
    log(f"[7b] profile: {prof['device_launches_per_token']:.0f} device "
        f"launches/token, device busy {busy:.3f} ms of {ms_tok:.3f} "
        f"ms/token (idle share {1 - busy / ms_tok:.1%})")
    for name, ms_k in prof["top"]:
        log(f"[7b] profile:   {ms_k:6.3f} ms/token  {name}")
    gs = graph_counts(model)
    log(f"[7b] step graphs: {gs['captures']} captures in "
        f"{gs['capture_ms']:.1f} ms, {gs['replays']} replays; prefill "
        f"graphs {gs['prefill_captures']} captures in "
        f"{gs['prefill_capture_ms']:.1f} ms, {gs['prefill_replays']} "
        f"replays; batch-1 host "
        f"{ms_tok:.3f} ms a token graphed against {ms_tok_e:.3f} eager "
        f"(same run); device busy {busy:.3f} ms graphed, {busy_e:.3f} eager; "
        f"idle share {1 - busy / ms_tok:.1%} graphed, "
        f"{1 - busy_e / ms_tok_e:.1%} eager")

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
            "profile_eager": prof_e, "step_graphs": graphs,
            "step_graphs_all": gs, "decode_ms_per_token_b1_eager": ms_tok_e,
            "prefill_only_ms": t_pre * 1e3, "prefill_only_ms_eager":
            t_pre_e * 1e3, "prefill_forward_ms": pre_g[0],
            "prefill_forward_device_ms": pre_g[1],
            "prefill_forward_ms_eager": pre_e[0], "prefill_keys": pkeys,
            "decode_tokens_per_s_b1": tps, "decode_ms_per_token_b1": ms_tok,
            "decode_vs_prefill_rel_err": rel, "tokens_b1": seq1.tolist()}


def profile_decode(model, prompt, n: int = 8) -> dict:
    """profile_round around generate_greedy(prompt, 1 + n) and
    generate_greedy(prompt, 1): their difference over n is one batch-1
    decode token's device time and launches."""

    def kernels(n_new):
        return profile_round(lambda: model.generate_greedy(prompt, n_new))[0]

    kernels(1 + n)                                    # warm-up
    long, short = kernels(1 + n), kernels(1)
    per = {k: ((t - short.get(k, (0.0, 0))[0]) / n,
               (c - short.get(k, (0.0, 0))[1]) / n)
           for k, (t, c) in long.items()}
    ranked = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)
    return {"device_ms_per_token": sum(t for t, _ in per.values()),
            "device_launches_per_token": sum(c for _, c in per.values()),
            "top": [(k[:70], t) for k, (t, _) in ranked[:6]],
            "kernels": [(k[:90], t, c) for k, (t, c) in ranked if c > 0]}


def profile_partials(model, prompt, n: int, tries: int = 3) -> dict:
    """The device kernels of one generate_greedy(prompt, 1 + n) session under
    torch.profiler, and the qmm_partials wrapper's count of the same session
    (zeroed just before it). The check is exactly one partials_kernel event
    a wrapper call and no group_sum or reduce_splits kernel. More events than
    calls, or a stray kernel, fails at once; fewer means the profiler lost
    records (it drops some, it never invents any), so the session is taken
    again, up to `tries` times, and fails if none gives equality."""
    model.generate_greedy(prompt, 1 + n)                 # warm-up
    for session in range(1, tries + 1):
        torch.cuda.synchronize()
        zero_counts()
        kern = profile_round(
            lambda: model.generate_greedy(prompt, 1 + n))[0]
        calls = launch_counts()["qmm_partials"]
        events = sum(c for name, (_, c) in kern.items()
                     if "partials_kernel" in name)
        stray = [name for name in kern
                 if "group_sum" in name or "reduce_splits" in name]
        if events > calls or stray:
            raise AssertionError(f"QMM_PARTIALS=1 session: {events} "
                                 f"partials_kernel events for {calls} calls, "
                                 f"stray {stray}")
        if events == calls:
            return {"kernels": kern, "events": events, "calls": calls,
                    "forwards": 1 + n, "sessions": session}
        log(f"[merged] QMM_PARTIALS=1 session {session}: {events} events "
            f"for {calls} calls (records lost); taking it again; its "
            f"linear kernels: " + "; ".join(
                f"{c}x {name[:60]}" for name, (_, c) in kern.items()
                if "qmm" in name or "partials" in name))
    raise AssertionError(f"QMM_PARTIALS=1: no session of {tries} recorded one "
                         f"partials_kernel event a call")


# ---------------------------------------------------------------- phase 6

PAGED_KINDS = ("bf16", "fp8", "q8", "q4", "q6")
PAGED_LAYERS, PAGED_POOL = 4, 24
PAGED_LENS = (1, 255, 256, 257, 1500)


def paged_pool(kind: str, hkv: int, gen, dev, d: int = 128):
    """A PagedKVCache of PAGED_POOL pages whose every row holds random K/V
    stored by the cache's own codec (kv_quant)."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache, _kinds, _raw
    from exllamav2_tpu_torch.ops.kvquant import kv_quant
    cache = PagedKVCache.alloc(PAGED_LAYERS, PAGED_POOL, hkv, d, kind,
                               device=dev)
    for data, scales, k in ((cache.k_data, cache.k_scales, _kinds(kind)[0]),
                            (cache.v_data, cache.v_scales, _kinds(kind)[1])):
        for layer in range(PAGED_LAYERS):
            x = torch.randn((hkv, data.shape[2], d), generator=gen,
                            device=dev)
            qd, qs = kv_quant(x, k)
            _raw(data)[layer] = _raw(qd)
            if scales is not None:
                scales[layer] = qs
    return cache


def paged_cases():
    cases = [dict(kind=k, b=b, hkv=h, cap=0.0, win=0)
             for k in PAGED_KINDS for h in (32, 8) for b in (1, 16)]
    cases += [dict(kind="bf16", b=16, hkv=8, cap=30.0, win=0),
              dict(kind="bf16", b=16, hkv=8, cap=0.0, win=512),
              dict(kind="q4", b=16, hkv=8, cap=0.0, win=512),
              # one serving16 decode step's shape (the kernels line)
              dict(kind="bf16", b=16, hkv=32, cap=0.0, win=0, serving=True)]
    # Qwen2.5-VL-7B's 28/4 heads: a group of 7, a partial group of the
    # kernel's 16-row query tile
    cases += [dict(kind=k, b=b, hkv=4, hq=28, cap=0.0, win=0)
              for k in PAGED_KINDS for b in (1, 16)]
    # Gemma-3-12B's 16/8 heads at D = 256 and Llama-3-70B's 64/8
    cases += [dict(kind=k, b=b, hkv=hkv, hq=hq, d=d, cap=0.0, win=0)
              for hq, hkv, d in GQA_HEADS if hq != 28
              for k in PAGED_KINDS for b in (1, 16)]
    return cases


def phase_paged(dev, rate, cases=None, tag="paged"):
    from exllamav2_tpu_torch.cache_paged import _kinds, _raw
    from exllamav2_tpu_torch.ops import paged_attn as P
    import torch.nn.functional as Fn
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cpu_gen = torch.Generator().manual_seed(7)
    ps = 256
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst, pools = [], 0.0, {}
    for case in cases or paged_cases():
        kind, b, hkv = case["kind"], case["b"], case["hkv"]
        hq, cap, win = case.get("hq", HEADS), case["cap"], case["win"]
        d = case.get("d", 128)
        scale = d ** -0.5
        kk, vk = _kinds(kind)
        if (kind, hkv, d) not in pools:
            pools.clear()
            torch.cuda.empty_cache()
            pools[(kind, hkv, d)] = paged_pool(kind, hkv, gen, dev, d)
        cache = pools[(kind, hkv, d)]
        if case.get("serving"):
            lens = [SERVE_PROMPT + SERVE_NEW // 2] * b    # mean of 128..175
            pw = 2
        elif b == 1:
            lens, pw = [1500], 8
        else:       # every length, the last row a pad row on the null page
            lens, pw = [PAGED_LENS[i % 5] for i in range(b - 1)] + [1], 8
        bt = torch.zeros((b, pw), dtype=torch.int32)
        for i, n in enumerate(lens):
            perm = torch.randperm(PAGED_POOL - 1, generator=cpu_gen) + 1
            live = -(-n // ps)
            bt[i, :live] = perm[:live].to(torch.int32)
        if not case.get("serving") and b > 1:
            bt[-1] = 0                                   # pad row
        bt = bt.to(dev)
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        qs = [torch.randn((b, hq, d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(PAGED_LAYERS)]
        # the kernel's grid: blocks of one cluster over the block table
        # (one split where the batch's pairs fill the card, as serving16's)
        _, chunks, mt, splits, per = P.grid(b, hkv, hq // hkv, pw, ps, sms)
        if b == 1 and splits < 2:
            raise AssertionError(f"paged {case}: one split ({per} rows)")

        # q4 / q8 keys carry the Hadamard gain of 32 in the kernel's
        # domain; paged_attention folds 1/32 into the scale, and so do we
        sc = scale / 32 if kk in ("q4", "q8") else scale

        def args(layer):
            return (qs[layer], cache.k_data, cache.v_data, layer, bt, vl,
                    cache.k_scales, cache.v_scales, sc, ps, hq, (kk, vk),
                    cap, win)

        ref = P.paged_decode_attention_plain(*args(1))
        vdata = _raw(cache.v_data)[1].view(cache.v_data.dtype)
        vmax = P._dq_page(vdata, None if cache.v_scales is None
                          else cache.v_scales[1], vk).abs().max().item()

        def run():
            got = P.paged_decode_attention(*args(1))
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.isfinite(got).all() or err > ATTN_TOL * vmax:
                mt_run = P.grid(b, hkv, hq // hkv, pw, ps, sms)[2]
                raise AssertionError(
                    f"paged {case} {template_name(mt_run)}: err "
                    f"{err:.3g} (max |v| {vmax:.3g})")
            return err, graph_ms([
                (lambda layer=layer: P.paged_decode_attention(*args(layer)))
                for layer in range(PAGED_LAYERS)], 64)

        err, ms = run()
        worst = max(worst, err)
        plain_ms = eager_ms(lambda: P.paged_decode_attention_plain(
            *args(0)), 3)
        lib_ms = None
        if not cap:
            # yardstick: SDPA on K/V already gathered from the pages and
            # dequantized to bf16 (the gather is not timed)
            pos = torch.arange(pw * ps, device=dev)
            vlc = vl.long()[:, None]
            mask = pos[None] < vlc
            if win:
                mask &= pos[None] >= vlc - win
            mask = mask[:, None, None, :]
            idx = (bt.long()[..., None] * ps + torch.arange(
                ps, device=dev)).reshape(b, -1)

            def dense(data, scales, k, layer):
                raw = _raw(data)[layer][:, idx].view(data.dtype)
                sc = None if scales is None else scales[layer][:, idx]
                return P._dq_page(raw, sc, k).to(torch.bfloat16) \
                    .transpose(0, 1).contiguous()
            kv = [(dense(cache.k_data, cache.k_scales, kk, layer),
                   dense(cache.v_data, cache.v_scales, vk, layer))
                  for layer in range(PAGED_LAYERS)]

            def sdpa(layer):
                return lambda: Fn.scaled_dot_product_attention(
                    qs[layer][:, :, None], kv[layer][0], kv[layer][1],
                    attn_mask=mask, scale=sc, enable_gqa=hkv != hq)
            lib_ms = graph_ms([sdpa(layer) for layer in
                               range(PAGED_LAYERS)], 64)
            del kv
        read = [min(n, win) if win else n for n in lens]
        nbytes = (sum(read) * hkv * (row_bytes(kk, d) + row_bytes(vk, d))
                  + b * hq * d * (2 + 4) + bt.numel() * 4 + b * 4)
        flops = 4 * (hq // hkv) * d * sum(read) * hkv
        bound = max(nbytes / rate, flops / PEAK_BF16) * 1e3
        bound_by = "bytes" if nbytes / rate >= flops / PEAK_BF16 \
            else "operations"
        rows.append(dict(case, d=d, hq=hq, lens=lens, max_abs_err=err,
                         max_abs_v=vmax, blocks=chunks,
                         template=template_name(mt), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bytes=nbytes, flops=flops, bound_ms=bound,
                         bound_by=bound_by, splits=splits,
                         rows_per_split=per, cluster=splits))
        lib_s = f"{lib_ms * 1e3:7.1f}us" if lib_ms is not None else "   n/a"
        log(f"[{tag}] {kind:4s} b={b:2d} {hq}/{hkv:2d} d={d} "
            f"{template_name(mt)} blocks={chunks} cap={cap:4.1f} "
            f"win={win:3d}{' serving' if case.get('serving') else ''} "
            f"splits={splits:2d}x{per:4d} rows (cluster {splits:2d}) "
            f"err={err:.2e} (|v|<={vmax:.1f}) kernel={ms * 1e3:7.1f}us"
            f" plain={plain_ms * 1e3:8.1f}us sdpa(gathered)={lib_s} "
            f"bound={bound * 1e3:5.1f}us ({bound / ms * 100:4.1f}% of "
            f"roofline)")
        del qs
    pools.clear()
    torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------- phase 7

def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from exllamav2_tpu_torch.ops import decode_attn as A
    from exllamav2_tpu_torch.ops import paged_attn as P
    from exllamav2_tpu_torch.ops import qmm as Q
    return {**Q.LAUNCHES, **A.LAUNCHES, **P.LAUNCHES}


def zero_counts() -> None:
    from exllamav2_tpu_torch.ops import decode_attn as A
    from exllamav2_tpu_torch.ops import paged_attn as P
    from exllamav2_tpu_torch.ops import qmm as Q
    for counts in (Q.LAUNCHES, A.LAUNCHES, P.LAUNCHES, Q.GATED_LAUNCHES):
        for key in counts:
            counts[key] = 0
    P.KIND_LAUNCHES.clear()


def serve_prompts(rng) -> list:
    return [rng.integers(3, 250, SERVE_PROMPT).astype(np.int32)
            for _ in range(SERVE_JOBS)]


def serve_round(gen, prompts):
    """One serving16 round through `gen`: enqueue every prompt, iterate
    until all are done. Returns (jobs, new tokens, wall seconds)."""
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jobs = [gen.enqueue(DynamicJob(p, max_new_tokens=SERVE_NEW,
                                   settings=Settings.greedy()))
            for p in prompts]
    iterate_delivering(gen, jobs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # (counted per job: a streaming result holds back the tokens of an
    # unfinished UTF-8 sequence)
    return jobs, sum(j.new_tokens for j in jobs), dt


def iterate_delivering(gen, jobs) -> None:
    """gen.iterate() until every job is done, each job's time_delivered the
    return of the iterate() that handed its first token to the caller. A
    decode burst stamps the k tokens it reads back at once at even steps of
    its dispatch interval (their times inside it are not observable), so
    the generator's own time of a first token (TTFT) leaves out device work
    still queued when the burst was dispatched, such as a prefill replayed
    without a wait; the delivery time holds all of it."""
    while any(j.status != "done" for j in jobs):
        gen.iterate()
        t = time.perf_counter()
        for j in jobs:
            if j.new_tokens and not getattr(j, "time_delivered", 0.0):
                j.time_delivered = t


def delivered_p50(jobs, since: str = "time_enqueue") -> float:
    """p50 ms from each job's `since` to its first token's delivery."""
    d = sorted((j.time_delivered - getattr(j, since)) * 1e3 for j in jobs)
    return d[len(d) // 2]


def check_round(name, jobs, new, dt, vocab=VOCAB):
    """Every job ran all its tokens; returns (tokens/s, p50 TTFT ms, TTFTs
    ms)."""
    for j in jobs:
        gen_ids = j.sequence[SERVE_PROMPT:]
        if (j.new_tokens != SERVE_NEW or j.eos_reason != "max_new_tokens"
                or gen_ids.min() < 0 or gen_ids.max() >= vocab):
            raise AssertionError(f"{name} job: {j.new_tokens} tokens, "
                                 f"{j.eos_reason}")
    ttfts = sorted((j.time_first_token - j.time_enqueue) * 1e3 for j in jobs)
    return new / dt, ttfts[len(ttfts) // 2], ttfts


def call_kernels(call, calls: int = 16, tries: int = 3) -> dict:
    """Device kernels of `calls` calls of `call` under torch.profiler, after
    a warm-up call: {name: (ms, count)}. A session that records no device
    event at all says nothing about the calls (the profiler once returned
    none for a one-call session late in a full run), so up to `tries`
    sessions are taken until one records some."""
    call()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            call()
    for _ in range(tries):
        kern = profile_round(run)[0]
        if kern:
            break
    return kern


def profile_round(run):
    """Device time by kernel name over one call of `run` under
    torch.profiler, CUDA activity only, summed from the raw trace (building
    key_averages()'s tables takes minutes for a round of ~10^5 kernels):
    ({name: (ms, count)}, busy ms, wall seconds of the call)."""
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t, c = per.get(e.name(), (0.0, 0))
            per[e.name()] = (t + e.duration_ns() / 1e6, c + 1)
    return per, sum(t for t, _ in per.values()), dt


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def prefill_products(per, tag) -> dict:
    """The matrix-product kernels of a profiled serving round (the batched
    prefill's linears and t > 1 attention; the decode steps run the port's
    kernels): logged by name, and an f32 GEMM fails the phase (the prefill
    multiplies bf16 on the tensor cores with f32 results: ops/qmm._dot,
    ops/paged_attn.gqa_scores / gqa_values)."""
    gemms = {k: v for k, v in per.items()
             if any(g in k.lower() for g in GEMM_NAMES)}
    total = sum(t for t, _ in gemms.values())
    log(f"[{tag}] prefill products: {total:.1f} ms in "
        f"{sum(c for _, c in gemms.values())} launches")
    for name, (t, c) in sorted(gemms.items(), key=lambda kv: -kv[1][0]):
        log(f"[{tag}] prefill products: {t:8.2f} ms {c:6d}x  {name[:90]}")
    f32 = [k for k in gemms if "f32f32" in k or "sgemm" in k.lower()]
    if f32:
        raise AssertionError(f"{tag}: f32 GEMM in the prefill: {f32}")
    return {"ms": total, "by_kernel": {k[:90]: v for k, v in gemms.items()}}


def teacher_forced_logits(model, prompt, toks) -> list:
    """Logits of the linear-cache forward on a job's tokens: after the
    prompt, then after each generated token but the last. The steps run
    eagerly: this is the reference side of a comparison (and phase 9 swaps
    kernels under it)."""
    def run():
        lc = model.new_cache(1, 256)
        lg, lc = model.forward(prompt[None], lc, 0, last_token_only=True)
        ref = [lg[0, -1].cpu()]
        for i, t in enumerate(toks[:-1]):
            lg, lc = model.forward(np.asarray([[t]], np.int32), lc,
                                   len(prompt) + i)
            ref.append(lg[0, -1].cpu())
        return ref
    return eager(model, run)


def same_tokens(tag, graphed_jobs, eager_jobs):
    """The jobs of a graphed round against the same jobs run eagerly:
    bitwise the same tokens, or the phase fails."""
    a = [j.sequence.tolist() for j in graphed_jobs]
    b = [j.sequence.tolist() for j in eager_jobs]
    same = sum(x == y for x, y in zip(a, b))
    log(f"[{tag}] graphed tokens equal the eager round's in {same} of "
        f"{len(a)} jobs")
    if a != b:
        raise AssertionError(f"{tag}: graphed and eager tokens differ")


def graph_line(tag, tot, g, dt, dt_e, busy=None, busy_e=None):
    """One line per serving path: captures (their ms: warm-up, capture and
    instantiation), replays, host ms a decode dispatch graphed and eager,
    device busy and idle share. `g` is graph_counts over the measured round
    (which must capture nothing), `tot` graph_counts of the generator after
    it, dt / dt_e the seconds of the graphed and eager rounds (a dispatch's
    share holds the prefill)."""
    no_captures(tag, g)
    n = max(1, g["replays"])
    line = (f"[{tag}] step graphs: {tot['captures']} keys captured in "
            f"{tot['capture_ms']:.1f} ms in all, prefills "
            f"{tot['prefill_captures']} in {tot['prefill_capture_ms']:.1f} "
            f"ms; the measured round {g['captures']} captures, "
            f"{g['replays']} replays and {g['prefill_replays']} prefill "
            f"replays; host {dt * 1e3 / n:.2f} ms a dispatch "
            f"graphed against {dt_e * 1e3 / n:.2f} eager (prefill included)")
    if busy is not None:
        line += (f"; device busy {busy:.1f} ms, idle share "
                 f"{1 - busy / (dt * 1e3):.1%}")
    if busy_e is not None:
        line += (f" (eager: busy {busy_e:.1f} ms, idle share "
                 f"{1 - busy_e / (dt_e * 1e3):.1%})")
    log(line)
    return dict(g, host_ms_per_dispatch=dt * 1e3 / n,
                host_ms_per_dispatch_eager=dt_e * 1e3 / n,
                all_captures=tot["captures"],
                all_capture_ms=tot["capture_ms"],
                all_prefill_captures=tot["prefill_captures"],
                all_prefill_capture_ms=tot["prefill_capture_ms"])


def job_logits(gen, prompt, new_tokens: int):
    """Run one greedy job with return_logits: (per-step logits, tokens)."""
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    job = gen.enqueue(DynamicJob(prompt, max_new_tokens=new_tokens,
                                 settings=Settings.greedy(),
                                 return_logits=True))
    got = []
    while job.status != "done":
        for r in gen.iterate():
            if r.get("logits") is not None:
                got.append(torch.from_numpy(r["logits"][0]))
    return got, job.sequence[len(prompt):]


def phase_serving(dev, rate):
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import (
        DynamicGenerator, DynamicJob)
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.ops import paged_attn as P
    from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    w, st = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 heads=HEADS, kv_heads=HEADS, inter=INTER,
                                 max_seq=2048, bits=4, seed=0, device=dev)
    model = Model(precompute_model_scales(w), st)
    tok = ByteTokenizer(256)        # no EOS id: every job runs all its tokens
    cache = PagedKVCache.alloc(LAYERS, SERVE_PAGES, HEADS, HIDDEN // HEADS,
                               "bf16", device=dev)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved()
    gen = DynamicGenerator(model, cache, tok, max_batch_size=SERVE_JOBS,
                           max_chunk_size=512, decode_burst=16)
    rng = np.random.default_rng(0)

    t_warm = time.perf_counter()
    serve_round(gen, serve_prompts(rng))                 # warm round
    t_warm = time.perf_counter() - t_warm
    zero_counts()
    round_prompts = serve_prompts(rng)
    g0 = graph_counts(gen)
    with PrefillTimer(gen) as pt:
        jobs, new, dt = serve_round(gen, round_prompts)  # measured round
    got = launch_counts()
    g_round = graph_counts(gen, g0)
    mem_g = torch.cuda.memory_reserved() - mem0
    # 48 decode steps, each 225 fused linears (32 x 7 + the head) at m = 16
    # and one paged-attention launch per layer; the batched 16 x 128-row
    # prefill takes the dequant + matmul path and skips the head
    want = {"qmm": (7 * LAYERS + 1) * SERVE_NEW, "qmm_w4a8": 0,
            "qmm_partials": 0, "decode_attn": 0,
            "paged_decode_attn": LAYERS * SERVE_NEW}
    log(f"[serve] serving16 launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"serving16 launch counts {got} != {want}")
    tps, p50, ttfts = check_round("serving16", jobs, new, dt)
    dlv = delivered_p50(jobs)
    log(f"[serve] serving16: {new} tokens in {dt * 1e3:.1f} ms = "
        f"{tps:.1f} tokens/s, p50 TTFT {p50:.1f} ms, first token delivered "
        f"at p50 {dlv:.1f} ms (warm round {t_warm:.1f} s)")

    # device busy time of one more round, under the profiler
    per, busy, dt_prof = profile_round(
        lambda: serve_round(gen, serve_prompts(rng)))
    top = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    paged_prof = [(t, c) for k, (t, c) in per.items()
                  if "paged_attn_kernel" in k]
    paged_in_situ = (sum(t for t, _ in paged_prof) /
                     max(1, sum(c for _, c in paged_prof)))
    log(f"[serve] profile: device busy {busy:.1f} ms over the "
        f"{dt * 1e3:.1f} ms measured round (idle share {1 - busy / (dt * 1e3):.1%}"
        f"; profiled round {dt_prof * 1e3:.1f} ms, idle "
        f"{1 - busy / (dt_prof * 1e3):.1%}); paged kernel "
        f"{paged_in_situ * 1e3:.1f} us per launch in the round")
    for name, (t, c) in top:
        log(f"[serve] profile: {t:8.2f} ms {c:6d}x  {name[:70]}")
    prefill = prefill_products(per, "serve")

    # paged logits of one job against the linear-cache forward,
    # teacher-forced on the same tokens
    prompt = rng.integers(3, 250, SERVE_PROMPT).astype(np.int32)
    paged, toks = job_logits(gen, prompt, 8)
    ref = teacher_forced_logits(model, prompt, toks)
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(paged, ref))
    log(f"[serve] paged vs linear-cache logits over {len(paged)} steps: "
        f"rel err {rel:.2e}")
    if len(paged) != 8 or not rel < 0.02:
        raise AssertionError(f"paged vs linear logits rel err {rel}")

    # the measured round's prompts through an eager generator on the same
    # (now idle) cache, the graphed generator and its graphs gone: the same
    # tokens; its time and, in one more round, its device busy, against the
    # graphed round's; the memory each reserved beyond the model and cache
    tot = graph_counts(gen)
    pkeys = prefill_keys("serve", gen)
    del gen
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved()
    gen_e = DynamicGenerator(model, cache, tok, max_batch_size=SERVE_JOBS,
                             max_chunk_size=512, decode_burst=16,
                             graphs=False)
    with PrefillTimer(gen_e) as pt_e:
        jobs_e, new_e, dt_e = serve_round(gen_e, round_prompts)
    mem_e = torch.cuda.memory_reserved() - mem0
    same_tokens("serve", jobs, jobs_e)
    tps_e = new_e / dt_e
    _, p50_e, _ = check_round("serving16 eager", jobs_e, new_e, dt_e)
    dlv_e = delivered_p50(jobs_e)
    _, busy_e, _ = profile_round(
        lambda: serve_round(gen_e, serve_prompts(rng)))
    graphs = graph_line("serve", tot, g_round, dt, dt_e, busy, busy_e)
    pre = prefill_line("serve", pt.summary(), pt_e.summary(), (p50, p50_e),
                       (1 - busy / (dt * 1e3), 1 - busy_e / (dt_e * 1e3)),
                       (dlv, dlv_e))
    log(f"[serve] serving16 eager in the same run: {tps_e:.1f} tokens/s "
        f"against {tps:.1f} graphed; memory reserved beyond the model and "
        f"cache {mem_g / 2**20:.0f} MiB graphed (the graphs' pool), "
        f"{mem_e / 2**20:.0f} MiB eager")
    del gen_e, cache
    torch.cuda.empty_cache()

    # q4 cache: three jobs reuse the first job's hashed prompt page
    cache4 = PagedKVCache.alloc(LAYERS, 8, HEADS, HIDDEN // HEADS, "q4",
                                device=dev)
    prefix = rng.integers(3, 250, 300).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(3, 250, 20)
                               .astype(np.int32)]) for _ in range(4)]

    def q4_round(graphed):
        gen4 = DynamicGenerator(model, cache4, tok, max_batch_size=4,
                                decode_burst=8, graphs=graphed)
        first = gen4.enqueue(DynamicJob(prompts[0], max_new_tokens=8,
                                        settings=Settings.greedy()))
        while first.status != "done":
            gen4.iterate()
        rest = [gen4.enqueue(DynamicJob(p, max_new_tokens=8,
                                        settings=Settings.greedy(),
                                        return_logits=i == 0))
                for i, p in enumerate(prompts[1:])]
        finals, logits4 = {}, []
        while any(j.status != "done" for j in rest):
            for r in gen4.iterate():
                if r.get("logits") is not None:
                    logits4.append(r["logits"])
                if r.get("eos"):
                    finals[r["serial"]] = r
        return first, rest, finals, logits4

    P.KIND_LAUNCHES.clear()
    first, rest, finals, logits4 = q4_round(True)
    q4_launches = P.KIND_LAUNCHES.get("q4/q4", 0)
    first_e, rest_e, _, _ = q4_round(False)
    same_tokens("serve q4", [first] + rest, [first_e] + rest_e)
    cached = [finals[id(j)]["cached_tokens"] for j in rest]
    log(f"[serve] q4 round: cached_tokens {cached}, q4 kernel launches "
        f"{q4_launches}, tokens {[j.sequence[320:].tolist() for j in rest]}")
    if (cached != [256] * 3 or q4_launches != 2 * 8 * LAYERS
            or not all(np.isfinite(x).all() for x in logits4)
            or len(logits4) != 8
            or any(j.new_tokens != 8 for j in [first] + rest)):
        raise AssertionError(f"q4 round: cached {cached}, launches "
                             f"{q4_launches}")
    del cache4, model, w
    torch.cuda.empty_cache()
    return {"launches": got, "tokens_per_s": tps, "round_ms": dt * 1e3,
            "tokens_per_s_eager": tps_e, "device_busy_ms_eager": busy_e,
            "step_graphs": graphs, "prefill": pre, "prefill_keys": pkeys,
            "memory_reserved_mib": mem_g / 2**20,
            "memory_reserved_mib_eager": mem_e / 2**20,
            "p50_ttft_ms": p50, "p50_ttft_ms_eager": p50_e, "ttft_ms": ttfts,
            "p50_delivered_ms": dlv, "p50_delivered_ms_eager": dlv_e,
            "prompts": [p.tolist() for p in round_prompts],
            "tokens": [j.sequence[SERVE_PROMPT:].tolist() for j in jobs],
            "device_busy_ms": busy, "idle_share": 1 - busy / (dt * 1e3),
            "prefill_products": prefill,
            "profiled_round_ms": dt_prof * 1e3,
            "paged_kernel_us_in_round": paged_in_situ * 1e3,
            "top_kernels": [(k[:70], t, c) for k, (t, c) in top],
            "paged_vs_linear_rel_err": rel, "q4_cached_tokens": cached,
            "q4_kernel_launches": q4_launches}


# ---------------------------------------------------------------- phase 8

W4A8_KINDS = ("gptq_gs128_bf16meta", "gptq_gs128_f32meta",
              "gptq_gs128_actorder", "exl2_4b_gs32", "exl2_mixed_8356")


def phase_partials(dev, rate):
    """Kernels 4 and 5 and kernel 1's merged meta kind against their plain
    versions. Returns (rows, worst abs err) per kernel."""
    from exllamav2_tpu_torch.ops import qmm as Q
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    out = {}
    rows, worst = [], 0.0
    for kind in W4A8_KINDS:
        for (k, n) in MERGED_SHAPES:
            worst = max(worst, check_and_time(
                "w4a8:" + kind,
                lambda: make_w4a8_linear(kind, k, n, gen, dev), k, n,
                Q.w4a8_segment_matmul, Q.qmm_w4a8_plain, gen, dev, rate,
                rows))
    out["w4a8"] = (rows, worst)
    rows, worst = [], 0.0
    for (k, n) in SHAPES:
        worst = max(worst, check_and_time(
            "partials:gptq_4b_gs128",
            lambda: make_linear("gptq_4b_gs128", k, n, gen, dev), k, n,
            Q.partials_segment_matmul, Q.qmm_partials_plain, gen, dev, rate,
            rows))
    out["partials"] = (rows, worst)
    out["src_cols"] = qmm_src_cols(dev, rate, gen)
    for rs, _ in out.values():
        for r in rs:
            r["kind"] = r["kind"].split(":")[1]
    return out


def qmm_src_cols(dev, rate, gen):
    """Kernel 1's merged meta kind (src_cols) at the merged q|k|v and
    gate|up shapes: (rows, worst abs err)."""
    from exllamav2_tpu_torch.ops import qmm as Q
    rows, worst = [], 0.0
    for k, widths in ((HIDDEN, (HIDDEN,) * 3), (HIDDEN, (INTER,) * 2)):
        worst = max(worst, check_and_time(
            f"qmm:exl2_4b_merged{len(widths)}",
            lambda: make_merged_linear(k, widths, gen, dev), k, sum(widths),
            Q.fused_segment_matmul, Q.qmm_plain, gen, dev, rate, rows))
    return rows, worst


# ---------------------------------------------------------------- phase 9

def phase_merged(dev, rate, base):
    """The merged + W4A8 serving path, the scales-on-partials greedy call
    and the merged-only exactness round. `base` is phase 7's result."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.models.modules import ModelWeights
    from exllamav2_tpu_torch.ops import qmm as Q
    from exllamav2_tpu_torch.ops.dequant import (
        enable_w4a8, merge_serving_weights, precompute_model_scales)
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    tok = ByteTokenizer(256)
    prompts = [np.asarray(p, np.int32) for p in base["prompts"]]
    rng = np.random.default_rng(1)

    def new_cache():
        return PagedKVCache.alloc(LAYERS, SERVE_PAGES, HEADS,
                                  HIDDEN // HEADS, "bf16", device=dev)

    def new_gen(model, **kw):
        return DynamicGenerator(model, new_cache(), tok,
                                max_batch_size=SERVE_JOBS,
                                max_chunk_size=512, decode_burst=16, **kw)

    def eager_round(gen, tag, jobs, dt, g_round, busy=None):
        """The measured round's prompts through an eager generator over the
        graphed one's (already merged / W4A8) weights, on a fresh cache:
        the same tokens. Returns (tokens/s eager, the graph line's dict)."""
        gen_e = new_gen(gen.model, prescale=False, graphs=False)
        jobs_e, new_e, dt_e = serve_round(gen_e, prompts)
        same_tokens(tag, jobs, jobs_e)
        return new_e / dt_e, graph_line(tag, graph_counts(gen), g_round, dt,
                                        dt_e, busy)

    # --- (a) GPTQ 4-bit gs128, merged + W4A8. The generator builds new
    # modules (GPTQ needs no prescale), so `exact` stays the unmerged model.
    w, st = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 heads=HEADS, kv_heads=HEADS, inter=INTER,
                                 max_seq=2048, bits=4, seed=0, fmt="gptq",
                                 device=dev)
    exact = Model(w, st)
    gen = new_gen(exact, merged_weights=True, w4a8=True)
    lw = gen.model.weights.layers[0]
    if not (lw.attn.qkv.segments[0].act8 and lw.mlp.gate_up.segments[0].act8
            and lw.mlp.down.segments[0].rows_pad == 11264
            and not gen.model.weights.head.segments[0].act8
            and not w.layers[0].attn.q.segments[0].act8):
        raise AssertionError("merged + W4A8 weights not as expected")
    t_warm = time.perf_counter()
    serve_round(gen, serve_prompts(rng))                 # warm round
    t_warm = time.perf_counter() - t_warm
    zero_counts()
    g0 = graph_counts(gen)
    jobs, new, dt = serve_round(gen, prompts)            # measured round
    got = launch_counts()
    g_round = graph_counts(gen, g0)
    # 48 decode steps at m = 16: per layer q|k|v, o, gate|up and down on the
    # W4A8 kernel, the exact head on the fused kernel, one paged-attention
    # launch per layer; the prefill dequantizes and skips the head
    want = {"qmm": SERVE_NEW, "qmm_w4a8": 4 * LAYERS * SERVE_NEW,
            "qmm_partials": 0, "decode_attn": 0,
            "paged_decode_attn": LAYERS * SERVE_NEW}
    log(f"[merged] serving16 merged+w4a8 launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"merged+w4a8 launch counts {got} != {want}")
    tps, p50, ttfts = check_round("merged+w4a8", jobs, new, dt)
    dlv = delivered_p50(jobs)
    per, busy, dt_prof = profile_round(
        lambda: serve_round(gen, serve_prompts(rng)))
    idle = 1 - busy / (dt * 1e3)
    top = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    log(f"[merged] serving16 merged+w4a8 (GPTQ gs128): {new} tokens in "
        f"{dt * 1e3:.1f} ms = {tps:.1f} tokens/s, p50 TTFT {p50:.1f} ms "
        f"(first token delivered at p50 {dlv:.1f} ms), "
        f"device busy {busy:.1f} ms, idle share {idle:.1%} (warm round "
        f"{t_warm:.1f} s; profiled round {dt_prof * 1e3:.1f} ms)")
    log(f"[merged] serving16 unmerged exact (EXL2, phase 7): "
        f"{base['tokens_per_s']:.1f} tokens/s, p50 TTFT "
        f"{base['p50_ttft_ms']:.1f} ms, device busy "
        f"{base['device_busy_ms']:.1f} ms, idle share "
        f"{base['idle_share']:.1%}")
    for name, (t, c) in top:
        log(f"[merged] profile: {t:8.2f} ms {c:6d}x  {name[:70]}")
    prefill = prefill_products(per, "merged")
    tps_e, graphs = eager_round(gen, "merged+w4a8", jobs, dt, g_round, busy)
    log(f"[merged] serving16 merged+w4a8 eager in the same run: "
        f"{tps_e:.1f} tokens/s against {tps:.1f} graphed")

    # W4A8 logits of one job, then teacher-forced on its tokens through the
    # linear-cache forward: the same weights on the kernel and on the
    # kernel's plain version (they differ by f32 sum order, which can flip
    # an int8 rounding of a later activation), and the exact model
    prompt = rng.integers(3, 250, SERVE_PROMPT).astype(np.int32)
    got8, toks = job_logits(gen, prompt, 12)
    got8 = torch.stack(got8)

    def forced(model, plain=False, calls=None):
        """Teacher-forced logits; `plain` runs the W4A8 plain version,
        `calls` (a list) gets, for every W4A8 call, the kernel's max
        relative difference from the plain version on the same input."""
        kernel_wrapper = Q.w4a8_segment_matmul
        if plain:
            Q.w4a8_segment_matmul = Q.qmm_w4a8_plain
        elif calls is not None:
            def both(x, seg, quantized=None):
                got = kernel_wrapper(x, seg, quantized)
                ref = Q.qmm_w4a8_plain(x, seg)
                calls.append(((got - ref).abs().max()
                              / ref.abs().max()).item())
                return got
            Q.w4a8_segment_matmul = both
        try:
            return torch.stack(teacher_forced_logits(model, prompt, toks))
        finally:
            Q.w4a8_segment_matmul = kernel_wrapper

    def max_rel(a, b):
        return ((a - b).abs().amax(1) / b.abs().amax(1)).max().item()

    def mean_dev(a, b):
        return ((a - b).abs().mean() / b.abs().mean()).item()

    ref = forced(exact)
    lin8 = forced(gen.model)
    n_launch = launch_counts()["qmm_w4a8"]
    plain8 = forced(gen.model, plain=True)
    if launch_counts()["qmm_w4a8"] != n_launch:
        raise AssertionError("the plain pass launched the W4A8 kernel")
    rel_plain = {LAYERS: max_rel(lin8, plain8)}
    dev_exact = {LAYERS: mean_dev(lin8, ref)}
    rel_paged = max_rel(got8, lin8)
    dev8 = mean_dev(got8, ref)
    agree = (got8.argmax(-1) == ref.argmax(-1)).float().mean().item()
    # the int8 rounding noise of every layer adds up along the residual, and
    # a flipped rounding decorrelates two W4A8 runs further down: both
    # limits are held at the depth of the reference's model test (2 layers)
    # and the numbers are read at 8 layers and at full depth too
    def cut_weights(depth):
        """The first `depth` layers of the GPTQ model under its own head."""
        return (ModelWeights(w.embed, list(w.layers[:depth]), w.final_norm,
                             w.head, w.sin, w.cos),
                dataclasses.replace(st, num_layers=depth,
                                    layers=st.layers[:depth]))

    rel_calls = {}
    for depth in (2, 8):
        cut, st_cut = cut_weights(depth)
        cut8 = Model(enable_w4a8(merge_serving_weights(cut)), st_cut)
        calls = []
        a = forced(cut8, calls=calls)
        rel_calls[depth] = max(calls)
        rel_plain[depth] = max_rel(a, forced(cut8, plain=True))
        dev_exact[depth] = mean_dev(a, forced(Model(cut, st_cut)))
        del cut8
    def fmt(by_depth):
        return {d: float(f"{v:.3g}") for d, v in sorted(by_depth.items())}

    log(f"[merged] W4A8 kernel vs plain version on the same activations, "
        f"every call of the teacher-forced pass, by depth: max rel err "
        f"{fmt(rel_calls)} (limit {W4A8_PLAIN_TOL} at 2 layers)")
    log(f"[merged] W4A8 logits over {len(toks)} teacher-forced steps, by "
        f"depth: a kernel pass vs a plain-version pass max rel err "
        f"{fmt(rel_plain)} (they part after an int8 rounding flips); vs the "
        f"exact forward mean relative deviation {fmt(dev_exact)} (limit "
        f"{W4A8_LOGITS_TOL} at 2 layers)")
    log(f"[merged] the generator's own W4A8 logits (paged cache): vs the "
        f"linear-cache W4A8 forward max rel err {rel_paged:.2e}; vs the "
        f"exact forward mean relative deviation {dev8:.4f}, same argmax in "
        f"{agree:.0%} of the steps")
    if not (torch.isfinite(got8).all() and 0 < dev8 < 0.5
            and rel_calls[2] < W4A8_PLAIN_TOL
            and 0 < dev_exact[2] < W4A8_LOGITS_TOL):
        raise AssertionError(f"W4A8: per call vs plain {rel_calls}, logits "
                             f"vs exact {dev_exact}, generator vs exact "
                             f"{dev8}")
    del gen, lw
    torch.cuda.empty_cache()

    # --- (b) QMM_PARTIALS=1: the scales-on-partials kernel serves every
    # linear of the unmerged GPTQ model, the gs128 head included
    prompt1 = rng.integers(3, VOCAB, (1, 16)).astype(np.int32)
    n_new = 8
    shallow = Model(*cut_weights(2))

    def prefill_logits():
        return [m.forward(prompt1, m.new_cache(1, 32), 0)[0]
                for m in (shallow, exact)]

    fused_logits = prefill_logits()
    os.environ["QMM_PARTIALS"] = "1"
    try:
        exact.generate_greedy(prompt1[:, :4], 2)             # warm-up
        zero_counts()
        g0 = graph_counts(exact)
        seq = exact.generate_greedy(prompt1, n_new)
        gotp = launch_counts()
        gp = graph_counts(exact, g0)
        seq_e = eager(exact, lambda: exact.generate_greedy(prompt1, n_new))
        part_logits = prefill_logits()
        sess = profile_partials(exact, prompt1, 4)
    finally:
        del os.environ["QMM_PARTIALS"]
    log(f"[merged] QMM_PARTIALS=1 generate_greedy: step graphs {gp}; "
        f"graphed tokens equal the eager path's: "
        f"{np.array_equal(seq, seq_e)}")
    if not np.array_equal(seq, seq_e) or gp["replays"] != n_new - 1:
        raise AssertionError(f"QMM_PARTIALS=1: graphed {seq.tolist()}, "
                             f"eager {seq_e.tolist()}, {gp}")
    # the device kernels of one QMM_PARTIALS=1 generate_greedy session: the
    # scales-on-partials kernel is one device kernel a linear (no separate
    # group-sum or split-reduce kernels), counted against the wrapper's own
    # count of the same session (profile_partials checks it)
    for name, (ms_k, cnt) in sess["kernels"].items():
        log(f"[merged] QMM_PARTIALS=1 session of {sess['forwards']} "
            f"forwards: {ms_k:7.3f} ms {cnt:6d}x  {name[:90]}")
    log(f"[merged] QMM_PARTIALS=1: {sess['events']} partials_kernel events "
        f"for {sess['calls']} wrapper calls ({7 * LAYERS + 1} a forward) in "
        f"session {sess['sessions']} of at most 3")
    wantp = {"qmm": 0, "qmm_w4a8": 0,
             "qmm_partials": (7 * LAYERS + 1) * n_new,
             "decode_attn": LAYERS * (n_new - 1), "paged_decode_attn": 0}
    # the two kernels round differently (the fused one rounds every weight
    # to bf16), and random layers amplify that with depth: the limit is held
    # at 2 layers, the full depth is read
    relp = {d: ((a - b).abs().max() / b.abs().max()).item()
            for d, a, b in zip((2, LAYERS), part_logits, fused_logits)}
    log(f"[merged] QMM_PARTIALS=1 generate_greedy: launches {gotp} "
        f"(expected {wantp}); 16-token forward vs the fused kernel, max rel "
        f"err by depth {fmt(relp)} (limit {PARTIALS_LOGITS_TOL} at 2 layers)")
    if (gotp != wantp or seq.shape != (1, 16 + n_new)
            or not (0 < relp[2] < PARTIALS_LOGITS_TOL and relp[LAYERS] < 0.5
                    and all(torch.isfinite(x).all() for x in part_logits))):
        raise AssertionError(f"QMM_PARTIALS path: {gotp}, rel {relp}")
    del shallow, fused_logits, part_logits
    del exact, w
    torch.cuda.empty_cache()

    # --- (c) merged only, on phase 7's EXL2 weights: merging is exact, so
    # the greedy tokens of phase 7's measured round must come out again
    w, st = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 heads=HEADS, kv_heads=HEADS, inter=INTER,
                                 max_seq=2048, bits=4, seed=0, device=dev)
    # unprescaled sources merge into the src_cols meta kind of the fused
    # kernel: a short job drives it through the serving path
    raw = new_gen(Model(w, st), merged_weights=True, prescale=False)
    seg = raw.model.weights.layers[0].attn.qkv.segments[0]
    if not (seg.src_cols == (0, HIDDEN, 2 * HIDDEN) and seg.scale_f is None):
        raise AssertionError("unprescaled merge did not keep src_cols")
    zero_counts()
    lg_raw, _ = job_logits(raw, prompts[0], 4)
    src_launches = launch_counts()["qmm"]
    if src_launches != (4 * LAYERS + 1) * 4 or not all(
            torch.isfinite(x).all() for x in lg_raw):
        raise AssertionError(f"src_cols round: {src_launches} launches")
    del raw, seg
    torch.cuda.empty_cache()
    model = Model(precompute_model_scales(w), st)
    gen = new_gen(model, merged_weights=True)
    if gen.model.weights.layers[0].attn.qkv.segments[0].scale_f is None:
        raise AssertionError("merged prescaled sources lost scale_f")
    serve_round(gen, serve_prompts(rng))                 # warm round
    zero_counts()
    g0 = graph_counts(gen)
    jobs_m, new_m, dt_m = serve_round(gen, prompts)
    gotm = launch_counts()
    gm = graph_counts(gen, g0)
    wantm = dict(want, qmm=(4 * LAYERS + 1) * SERVE_NEW, qmm_w4a8=0)
    tps_m, p50_m, _ = check_round("merged", jobs_m, new_m, dt_m)
    same = [j.sequence[SERVE_PROMPT:].tolist() == t
            for j, t in zip(jobs_m, base["tokens"])]
    log(f"[merged] merged-only EXL2 round (after a warm round of other "
        f"prompts): launches {gotm} (expected {wantm}), {tps_m:.1f} "
        f"tokens/s, p50 TTFT {p50_m:.1f} ms (delivered at p50 "
        f"{delivered_p50(jobs_m):.1f}); {sum(same)} of {len(same)} "
        f"jobs repeat phase 7's unmerged tokens")
    if gotm != wantm:
        raise AssertionError(f"merged launch counts {gotm} != {wantm}")
    rel_m = None
    if not all(same):
        # a near-tie flipped by the other split-K order of the wider
        # linears: hold the logits instead, teacher-forced on phase 7's
        # tokens of the first job that differs
        i = same.index(False)
        toks = np.asarray(base["tokens"][i], np.int32)
        merged = Model(merge_serving_weights(model.weights), st)
        a = torch.stack(teacher_forced_logits(merged, prompts[i], toks))
        b = torch.stack(teacher_forced_logits(model, prompts[i], toks))
        rel_m = ((a - b).abs().max() / b.abs().max()).item()
        log(f"[merged] job {i} differs: merged vs unmerged logits, "
            f"teacher-forced over {len(toks)} steps, rel err {rel_m:.2e} "
            f"(limit {MERGED_LOGITS_TOL})")
        if not rel_m < MERGED_LOGITS_TOL:
            raise AssertionError(f"merged vs unmerged logits rel {rel_m}")
    tps_me, graphs_m = eager_round(gen, "merged", jobs_m, dt_m, gm)
    log(f"[merged] merged-only eager in the same run: {tps_me:.1f} tokens/s "
        f"against {tps_m:.1f} graphed")
    del gen, model, w
    torch.cuda.empty_cache()
    return {"launches": got, "tokens_per_s": tps, "round_ms": dt * 1e3,
            "tokens_per_s_eager": tps_e, "step_graphs": graphs,
            "merged_tokens_per_s_eager": tps_me,
            "merged_step_graphs": graphs_m, "partials_step_graphs": gp,
            "p50_ttft_ms": p50, "ttft_ms": ttfts, "device_busy_ms": busy,
            "idle_share": idle, "profiled_round_ms": dt_prof * 1e3,
            "prefill_products": prefill,
            "top_kernels": [(k[:70], t, c) for k, (t, c) in top],
            "w4a8_kernel_vs_plain_rel_err_by_depth": rel_plain,
            "w4a8_kernel_vs_plain_per_call_rel_err_by_depth": rel_calls,
            "w4a8_mean_rel_dev_by_depth": dev_exact,
            "w4a8_paged_vs_linear_rel_err": rel_paged,
            "w4a8_logits_mean_rel_dev": dev8, "w4a8_argmax_agreement": agree,
            "partials_launches": gotp, "partials_logits_rel_err": relp,
            "partials_session": sess,
            "src_cols_launches": src_launches,
            "merged_launches": gotm, "merged_tokens_per_s": tps_m,
            "merged_p50_ttft_ms": p50_m, "merged_jobs_same_tokens": sum(same),
            "merged_logits_rel_err": rel_m}


# --------------------------------------------------------------- phase 10

TOOLS_GROUPS = (32, 128)    # QMM_GROUP values the tool kernels are held at
DMA_TOL = 1e-5              # per K tile, of max |plain|: f32 sum order only
# operations/s by operand type: the tensor-core rates, and the f32 rate of
# the plain ALUs for the casts and shifts
PEAK_OPS = {"bf16": PEAK_BF16, "int8": 1979e12, "int32": 67e12}


def phase_tools(dev, rate):
    """The tools path: the ten probes and the three perf_qmm kernels against
    their plain versions, timed; then the path itself (every variant and
    every probe through the functions the entry points call) with its
    launch counts; then both entry points as a user starts them."""
    from exllamav2_tpu_torch.ops import dequant as D
    from exllamav2_tpu_torch.tools import perf_qmm as T
    from exllamav2_tpu_torch.tools import probe_features as PF
    from exllamav2_tpu_torch.device import sm_count
    from exllamav2_tpu_torch.utils.timing import device_time
    card = card_line()
    sms = sm_count(dev)

    def us(call, like):
        return device_time(lambda _: call(), like, iters=64) * 1e3

    # --- the probes: kernel against plain version, result strings, times
    probes = {}
    for name, probe in PF.PROBES.items():
        tensors = PF.probe_tensors(name, dev)
        out = probe.kernel(*tensors)
        torch.cuda.synchronize()
        result = probe.verdict(tensors, out)
        ref = probe.plain(*tensors)
        err = (out.double() - ref.double()).abs().max().item()
        on_cpu = PF.run_probe(name, "cpu")
        if result != on_cpu:
            raise AssertionError(f"probe {name}: card says {result!r}, the "
                                 f"plain version on the CPU {on_cpu!r}")
        nbytes, ops, kind = probe.work
        lib = None
        if name == "bf16_dot_bf16_acc_f32":
            lib = us(lambda: torch.matmul(*tensors), tensors[0])
        elif name == "int8_dot" and hasattr(torch, "_int_mm"):
            lib = us(lambda: torch._int_mm(*tensors), tensors[0])
        probes[name] = dict(
            result=result, max_abs_err=err,
            ms=us(lambda: probe.kernel(*tensors), tensors[0]),
            plain_ms=eager_ms(lambda: probe.plain(*tensors), 5),
            bound_ms=max(nbytes / rate, ops / PEAK_OPS[kind]) * 1e3,
            bound_by="bytes" if nbytes / rate >= ops / PEAK_OPS[kind]
            else "operations", library_ms=lib)
        r = probes[name]
        log(f"[probe] {name} -> {result}  (err {err:.1e}, kernel "
            f"{r['ms'] * 1e3:.1f}us, plain {r['plain_ms'] * 1e3:.1f}us, "
            f"bound {r['bound_ms'] * 1e3:.2f}us by {r['bound_by']})")

    # --- the launch floor: a PyTorch kernel on a one-element tensor, timed
    # as the probes are (a yardstick for the register probes, not a kernel)
    one = torch.zeros(1, device=dev)
    floor_ms = us(lambda: one.add_(1), one)
    log(f"[probe] launch floor: {floor_ms * 1e3:.4f} us (the device_time "
        f"slope of add_ on a one-element tensor) | {card}")
    del one

    # --- the perf_qmm kernels at the 7B shapes, M = 8, 4 bits
    def rel(got, ref):
        assert torch.isfinite(got).all()
        return ((got - ref).abs().max() / ref.abs().max()).item(), \
            (got - ref).abs().max().item()

    rows = []

    def timed_row(kernel, k, n, gr, err, call, plain, lib, planes, nbytes,
                  ops, kind):
        ms = T.time_cycled(call, planes, planes[0]) * 1e3
        lib_ms = None if lib is None else T.time_cycled(
            lib[0], lib[1], planes[0]) * 1e3
        bound = max(nbytes / rate, ops / PEAK_OPS[kind]) * 1e3
        rows.append(dict(
            kernel=kernel, k=k, n=n, gr=gr, max_abs_err=err, ms=ms,
            plain_ms=eager_ms(plain, 3), library_ms=lib_ms, bytes=nbytes,
            plane_bytes=planes[0].numel() * 4, bound_ms=bound,
            bound_by="bytes" if nbytes / rate * 1e3 >= bound
            else "operations"))
        r = rows[-1]
        lib_s = "   n/a" if lib_ms is None else f"{lib_ms * 1e3:7.1f}us"
        log(f"[tools] {kernel:22s} {k:5d}x{n:5d} gr={gr:3d} err={err:.2e} "
            f"kernel={ms * 1e3:7.1f}us plain={r['plain_ms'] * 1e3:9.1f}us "
            f"lib={lib_s} bound={bound * 1e3:5.1f}us "
            f"({bound / ms * 100:4.1f}% of roofline)")

    for k, n in T.SHAPES:
        plane = T.mk_inputs(k, n, dev)[0]
        planes = T._copies(plane)
        tiles = T.dma_only_tiles(plane)
        ref = T.dma_only_tiles_plain(plane)
        torch.cuda.synchronize()
        r, err = rel(tiles, ref)
        last = plane.shape[0] // T.DMA_TILE - 1
        if (r > DMA_TOL or tiles.shape[0] != -(-plane.shape[0] // T.DMA_TILE)
                or not torch.equal(T.dma_only(plane),
                                   tiles[last].expand(8, n))):
            raise AssertionError(f"dma_only {k}x{n}: rel err {r:.3g}")
        timed_row("perf_qmm_dma_only", k, n, 0, err,
                  lambda p: T.dma_only(p),
                  lambda: T.dma_only_tiles_plain(plane),
                  (lambda p: p.sum(0, dtype=torch.float32), planes),
                  planes, plane.numel() * 4 + tiles.numel() * 4,
                  plane.numel(), "int32")
        for gr in TOOLS_GROUPS:
            plane, qs, smax, x = T.mk_inputs(k, n, dev, gr=gr)
            xb, xq = x.to(torch.bfloat16), T.quantize_x(x)
            x1 = T.group_sums(xq, gr)
            meta = qs.numel() + smax.numel() * 4 + T.M * n * 4
            dense = T.dense_weight(D.unpack_plane(plane, 4), qs, smax, gr)
            denses = [dense] + [dense.clone() for _ in
                                range(T.n_copies(dense.numel() * 2) - 1)]
            kt, nt = T.nibble_tiles(k, n, sms)
            for mode, xa in (("bf16", xb), ("int8", xq)):
                got = T.gp(xa, plane, qs, smax, bits=4, gr=gr)
                ref = T.gp_plain(xa, plane, qs, smax, 4, gr)
                torch.cuda.synchronize()
                r, err = rel(got, ref)
                log(f"[tools] gp_{mode} {k}x{n} gr={gr}: {-(-k // kt)} "
                    f"splits of {kt} rows (the cluster), {nt} columns a "
                    f"block")
                if r > QMM_TOL:
                    raise AssertionError(
                        f"gp_{mode} {k}x{n} gr={gr}: rel err {r:.3g}")
                timed_row(
                    f"perf_qmm_gp_{mode}", k, n, gr, err,
                    lambda p, xa=xa: T.gp(xa, p, qs, smax, bits=4, gr=gr),
                    lambda xa=xa: T.gp_plain(xa, plane, qs, smax, 4, gr),
                    (lambda w: torch.matmul(xb, w), denses), planes,
                    plane.numel() * 4 + meta + xa.numel() * xa.element_size(),
                    2 * T.M * k * n, mode)
                rows[-1]["tiles"] = {"splits": -(-k // kt), "cluster":
                                     -(-k // kt), "kt": kt, "nt": nt}
            ref = T.nibble_i8_plain(xq, x1, plane, qs, smax, gr)
            del denses, dense
            dense = T.dense_weight(T.nibble_values(plane, gr), qs, smax, gr)
            denses = [dense] + [dense.clone() for _ in
                                range(T.n_copies(dense.numel() * 2) - 1)]
            for tag, hints in (("", {}), ("_k2048", {"kt0": 2048}),
                               ("_n4096", {"nt0": 4096})):
                got = T.nibble_i8(xq, x1, plane, qs, smax, gr=gr, **hints)
                torch.cuda.synchronize()
                r, err = rel(got, ref)
                kt, nt = T.nibble_tiles(k, n, sms, **hints)
                log(f"[tools] nibble_i8{tag} {k}x{n} gr={gr}: {-(-k // kt)} "
                    f"splits of {kt} rows (the cluster), {nt} columns a "
                    f"block")
                if r > QMM_TOL:
                    raise AssertionError(
                        f"nibble_i8{tag} {k}x{n} gr={gr}: rel err {r:.3g}")
                timed_row(
                    "perf_qmm_nibble_i8" + tag, k, n, gr, err,
                    lambda p, hints=hints: T.nibble_i8(xq, x1, p, qs, smax,
                                                       gr=gr, **hints),
                    lambda: T.nibble_i8_plain(xq, x1, plane, qs, smax, gr),
                    (lambda w: torch.matmul(xb, w), denses), planes,
                    plane.numel() * 4 + meta + xq.numel() + x1.numel() * 4,
                    2 * T.M * k * n, "int8")
                rows[-1]["tiles"] = {"splits": -(-k // kt), "cluster":
                                     -(-k // kt), "kt": kt, "nt": nt}
            del denses, dense
        del planes
        torch.cuda.empty_cache()
    # --- gp at the other plane widths, both modes: checked, not timed
    gp_widths = {}
    for bits in (1, 2, 8):
        for gr in TOOLS_GROUPS:
            plane, qs, smax, x = T.mk_inputs(HIDDEN, HIDDEN, dev, seed=bits,
                                             bits=bits, gr=gr)
            for mode, xa in (("bf16", x.to(torch.bfloat16)),
                             ("int8", T.quantize_x(x))):
                r, err = rel(T.gp(xa, plane, qs, smax, bits=bits, gr=gr),
                             T.gp_plain(xa, plane, qs, smax, bits, gr))
                gp_widths[f"{mode} bits={bits} gr={gr}"] = r
                if r > QMM_TOL:
                    raise AssertionError(f"gp_{mode} bits={bits} gr={gr} "
                                         f"{HIDDEN}x{HIDDEN}: rel err {r:.3g}")
    log(f"[tools] gp at {HIDDEN}x{HIDDEN}, bits 1/2/8, against gp_plain: max "
        f"rel err {max(gp_widths.values()):.2e} over {len(gp_widths)} cases "
        f"(limit {QMM_TOL})")
    del plane, qs, smax, x
    torch.cuda.empty_cache()

    lines = []
    for kernel in dict.fromkeys(r["kernel"] for r in rows):
        for gr in dict.fromkeys(r["gr"] for r in rows
                                if r["kernel"] == kernel):
            sel = [r for r in rows if r["kernel"] == kernel and r["gr"] == gr]
            lines.append(T.report_line(
                f"{kernel.removeprefix('perf_qmm_')}"
                f"{f' (group {gr})' if gr else ''}",
                [(r["plane_bytes"], r["ms"] * 1e-3) for r in sel]))
            log(f"[tools] {lines[-1]} | {card}")

    # --- calls of each kernel redesigned as one launch, under the
    # profiler: one device kernel a call and nothing else, no reduce_splits
    plane, qs, smax, x = T.mk_inputs(HIDDEN, HIDDEN, dev, gr=32)
    xq = T.quantize_x(x)
    x1 = T.group_sums(xq, 32)
    xb = x.to(torch.bfloat16)
    ab = PF.probe_tensors("bf16_dot_bf16_acc_f32", dev)
    a8 = PF.probe_tensors("int8_dot", dev)
    a4 = PF.probe_tensors("int4_dot", dev)
    one_call, calls = {}, 16
    for name, kernel, call in (
            ("perf_qmm_nibble_i8", "nibble_kernel",
             lambda: T.nibble_i8(xq, x1, plane, qs, smax, gr=32)),
            ("perf_qmm_gp_bf16", "gp_kernel",
             lambda: T.gp(xb, plane, qs, smax, bits=4, gr=32)),
            ("perf_qmm_gp_int8", "gp_kernel",
             lambda: T.gp(xq, plane, qs, smax, bits=4, gr=32)),
            ("bf16_dot_bf16_acc_f32", "bf16_dot_kernel",
             lambda: PF._bf16_dot_kernel(*ab)),
            ("int8_dot", "int8_dot_kernel",
             lambda: PF._int8_dot_kernel(*a8)),
            ("int4_dot", "int8_dot_kernel",
             lambda: PF._int8_dot_kernel(*a4, int4=True))):
        kern = call_kernels(call, calls)
        for kname, (ms_k, cnt) in kern.items():
            log(f"[tools] {calls} {name} calls: {ms_k * 1e3:6.1f} us "
                f"{cnt}x {kname[:90]}")
        one_call[name] = {kname[:90]: cnt for kname, (_, cnt) in kern.items()}
        counts = list(kern.values())
        if (len(kern) != 1 or kernel not in next(iter(kern))
                or not 0 < counts[0][1] <= calls):
            raise AssertionError(f"{calls} {name} calls: device kernels "
                                 f"{kern}")
    del plane, qs, smax, x, xq, xb, x1, ab, a8, a4

    # --- the variants that time kernels 1 and 4: what each of their calls
    # returns against the plain version, on random activations at the
    # variant's own shapes and linears (EXL2, BITS, GR), before any timing
    from exllamav2_tpu_torch.ops import qmm as Q
    variant_err = {}
    for k, n in T.SHAPES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(k + n)
        x = torch.randn((T.M, k), dtype=torch.float32, generator=gen,
                        device=dev)
        xb = x.to(torch.bfloat16)
        lin = T.variant_linear(gen, k, n, dev, w4a8=False)
        lin8 = T.variant_linear(gen, k, n, dev, w4a8=True)
        (seg,), (seg8,) = lin.segments, lin8.segments
        assert lin.perm is None and seg.rows_pad == k == seg8.rows_pad
        ref, ref8 = Q.qmm_plain(xb, seg), Q.qmm_w4a8_plain(x, seg8)
        for name, got, want in (
                ("current", Q.qmm(xb, lin, fused=True), ref),
                ("w4a8_prod", Q.qmm(x, lin8, fused=True), ref8),
                ("w4a8_kernel", Q.w4a8_segment_matmul(
                    x, seg8, quantized=Q.w4a8_quantize(x, seg8.group_rows)),
                 ref8)):
            torch.cuda.synchronize()
            r, err = rel(got, want)
            log(f"[tools] variant {name:12s} {k:5d}x{n:5d} gr={T.GR:3d} "
                f"against its plain version: err={err:.2e} rel={r:.2e}")
            if r > QMM_TOL:
                raise AssertionError(
                    f"variant {name} {k}x{n}: rel err {r:.3g}")
            variant_err[name] = max(variant_err.get(name, 0.0), err)

    # --- the tools path itself: every variant and every probe through the
    # functions the entry points call, counts set to 0 before, read after.
    # A wrapper counts a call, also one made while a CUDA graph is captured
    # (a replay goes through no wrapper), so the expected count per variant
    # and shape is the number of calls one timing makes of its function,
    # counted here on a function that launches no kernel of the port.
    calls = [0]

    def counted(t):
        calls[0] += 1
        return t + 1

    T.time_cycled(counted, [torch.zeros(8, device=dev)], x)
    for counts in (T.LAUNCHES, PF.LAUNCHES):
        for key in counts:
            counts[key] = 0
    zero_counts()
    for name, fn in T.VARIANTS.items():
        lines.append(T.report_line(*fn(dev)))
        log(f"[tools] variant {lines[-1]} | {card}")
    strings = {name: PF.run_probe(name, dev) for name in PF.PROBES}
    got = {**T.LAUNCHES, **PF.LAUNCHES,
           **{k: v for k, v in launch_counts().items()
              if k in ("qmm", "qmm_w4a8")}}
    per = calls[0] * len(T.SHAPES)
    want = {"perf_qmm_dma_only": per, "perf_qmm_gp_bf16": per,
            "perf_qmm_gp_int8": per, "perf_qmm_nibble_i8": 3 * per,
            "probe_features": len(PF.PROBES), "qmm": per,
            "qmm_w4a8": 2 * per}
    log(f"[tools] wrapper calls on the tools path {got} (expected {want}: "
        f"{calls[0]} calls a timing, {len(T.SHAPES)} shapes)")
    if got != want or strings != {n: p["result"] for n, p in probes.items()}:
        raise AssertionError(f"tools path: launches {got} != {want} or "
                             f"probe strings {strings}")

    # --- both entry points as a user starts them, side by side, on one
    # variant and one probe each (the path above ran them all; their
    # timings share the card and are not kept)
    t0 = time.perf_counter()
    procs = {tool: subprocess.Popen(
        [sys.executable, "-m", "exllamav2_tpu_torch.tools." + tool, arg],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tool, arg in (("perf_qmm", "w4a8_kernel"),
                          ("probe_features", "int8_dot_batched"))}
    entry = {}
    for tool, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        entry[tool] = out.strip().splitlines()
        log(f"[tools] python -m exllamav2_tpu_torch.tools.{tool}: exit "
            f"{proc.returncode}, {len(entry[tool])} lines")
        if proc.returncode != 0 or any("FAIL" in x for x in entry[tool]):
            raise AssertionError(f"{tool} entry point failed:\n{out}")
    log(f"[tools] entry points ran in {time.perf_counter() - t0:.1f} s")
    return {"probes": probes, "rows": rows, "lines": lines, "launches": got,
            "calls_per_timing": calls[0], "variant_err": variant_err,
            "one_call_kernels": one_call, "entry_points": entry,
            "launch_floor_ms": floor_ms, "gp_widths": gp_widths}


# --------------------------------------------------------------- phase 11

CONS_NEW = 24               # new tokens of a constrained job
SELECT_OPTIONS = ["alpha", "bravo", "charlie", "delta"]
PREFIX = "Answer: "


def phase_constrained(dev):
    """Constrained generation on the serving path at 7B width: a free round
    of 16 jobs to learn their text, then 16 concurrent jobs under filters,
    banned strings, token healing and hooks, one token a dispatch; then a
    StreamingGenerator stream and four jobs under asyncio. Every job writes
    printable ASCII only (Settings.banned_tokens), so texts are readable."""
    import asyncio
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import (
        DynamicGenerator, DynamicJob)
    from exllamav2_tpu_torch.generator.dynamic_async import (
        DynamicGeneratorAsync, DynamicJobAsync)
    from exllamav2_tpu_torch.generator.filters import (
        PrefixFilter, SelectFilter)
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.generator.streaming import StreamingGenerator
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    w, st = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 heads=HEADS, kv_heads=HEADS, inter=INTER,
                                 max_seq=2048, bits=4, seed=0, device=dev)
    model = Model(precompute_model_scales(w), st)     # phase 7's model
    tok = ByteTokenizer(256)
    cache = PagedKVCache.alloc(LAYERS, SERVE_PAGES, HEADS, HIDDEN // HEADS,
                               "bf16", device=dev)
    gen = DynamicGenerator(model, cache, tok, max_batch_size=SERVE_JOBS,
                           max_chunk_size=512, decode_burst=16)
    not_text = [t for t in range(VOCAB) if not 32 <= t < 127]

    def text_only():
        s = Settings.greedy()
        s.banned_tokens = not_text
        return s

    rng = np.random.default_rng(11)
    prompts = [rng.integers(97, 123, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_JOBS)]

    def run_round(jobs):
        """Enqueue, iterate to the end; -> (decode steps, rewinds, seconds
        inside enqueue() and iterate()). The cache check after every step is
        not timed."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in jobs:
            gen.enqueue(j)
        busy = time.perf_counter() - t0
        steps = rewinds = 0
        while any(j.status != "done" for j in jobs):
            t0 = time.perf_counter()
            res = [r for r in gen.iterate() if r["stage"] == "streaming"]
            busy += time.perf_counter() - t0
            steps += bool(res)
            rewinds += sum(1 for r in res if len(r["token_ids"]) == 0)
            gen._validate_cache()
        return steps, rewinds, busy

    free = [DynamicJob(p, max_new_tokens=CONS_NEW, settings=text_only())
            for p in prompts]
    run_round(free)                                   # also the warm round
    texts = [j.emitted_text for j in free]
    if any(len(t) != CONS_NEW or not t.isascii() for t in texts):
        raise AssertionError(f"free round texts {texts}")
    log(f"[cons] free round: {texts[8]!r} ...")

    banned = {i: texts[i][4:7] for i in range(8, 12)}

    def constrained_jobs(seen):
        jobs = []
        for i, p in enumerate(prompts):
            kw = {}
            if i < 4:
                kw["filters"] = [SelectFilter(tok, SELECT_OPTIONS)]
            elif i < 8:
                kw["filters"] = [PrefixFilter(tok, PREFIX)]
            elif i < 12:
                kw["banned_strings"] = [banned[i]]
            elif i < 14:
                kw["token_healing"] = True
            else:
                kw["post_sampling_hooks"] = [seen[i].append]
                kw["return_top_tokens"] = 4
            jobs.append(DynamicJob(p, max_new_tokens=CONS_NEW,
                                   settings=text_only(), **kw))
        return jobs

    run_round(constrained_jobs({14: [], 15: []}))     # its keys' warm round
    seen = {14: [], 15: []}
    jobs = constrained_jobs(seen)
    zero_counts()
    g0 = graph_counts(gen)
    steps, rewinds, dt = run_round(jobs)
    got = launch_counts()
    g_round = graph_counts(gen, g0)
    want = {"qmm": (7 * LAYERS + 1) * steps, "qmm_w4a8": 0,
            "qmm_partials": 0, "decode_attn": 0,
            "paged_decode_attn": LAYERS * steps}
    new = sum(j.new_tokens for j in jobs)
    log(f"[cons] constrained round: {steps} steps, {rewinds} rewinds, "
        f"launches {got} (expected {want})")
    log(f"[cons] constrained round: {new} tokens in {dt * 1e3:.1f} ms = "
        f"{new / dt:.1f} tokens/s, {dt / steps * 1e3:.2f} ms of host clock "
        f"per step, the prefill included (one token a dispatch, "
        f"{SERVE_JOBS} jobs at the start)")
    if got != want:
        raise AssertionError(f"constrained launch counts {got} != {want}")
    for i, j in enumerate(jobs):
        t = j.emitted_text
        ok = t.isascii()
        if i < 4:
            ok &= t in SELECT_OPTIONS and j.eos_reason == "end_filter"
        elif i < 8:
            ok &= t.startswith(PREFIX) and j.new_tokens == CONS_NEW
        elif i < 12:
            ok &= (banned[i].lower() not in t.lower()
                   and j.new_tokens == CONS_NEW and t != texts[i])
        elif i < 14:
            # the first new token's piece starts with the healed piece
            healed = tok.id_to_piece(int(prompts[i][-1]))
            ok &= (j.prompt_len == SERVE_PROMPT - 1 and tok.id_to_piece(
                int(j.sequence[SERVE_PROMPT - 1])).startswith(healed))
        else:
            ok &= (len(seen[i]) == CONS_NEW and all(
                len(r.candidate_tokens) == 4
                and r.candidate_tokens[0] == r.sampled_token
                for r in seen[i]))
        if not ok:
            raise AssertionError(f"constrained job {i}: {t!r}, "
                                 f"{j.eos_reason}, {j.new_tokens} tokens")
    if rewinds < 4:
        raise AssertionError(f"{rewinds} rewinds for 4 banned-string jobs")
    gen.validate_cache()
    log(f"[cons] texts: select {[j.emitted_text for j in jobs[:4]]}, prefix "
        f"{jobs[4].emitted_text!r}, banned {banned[8]!r}: {texts[8]!r} -> "
        f"{jobs[8].emitted_text!r}")

    # one stream through the streaming generator (its own scheduler over
    # the same, now idle, cache)
    sg = StreamingGenerator(model, cache, tok)
    sg.begin_stream_ex(prompts[0], text_only(), max_new_tokens=12,
                       token_healing=True)
    chunks, eos = [], False
    while not eos:
        chunk, eos, _ = sg.stream()
        chunks.append(chunk)
    streamed = "".join(chunks)
    if len(streamed) != 12 or not streamed.isascii():
        raise AssertionError(f"stream: {streamed!r}")
    del sg

    async def four_jobs():
        agen = DynamicGeneratorAsync(gen)
        ajobs = [DynamicJobAsync(agen, p, max_new_tokens=12,
                                 settings=text_only(),
                                 filters=[PrefixFilter(tok, "ok ")])
                 for p in prompts[:4]]
        for j in ajobs:
            await agen.enqueue(j)
        out = []
        for j in ajobs:
            text = ""
            async for r in j:
                text += r.get("text", "")
            out.append(text)
        await agen.close()
        return out

    atexts = asyncio.run(four_jobs())
    if any(len(t) != 12 or not t.startswith("ok ") for t in atexts):
        raise AssertionError(f"async jobs: {atexts}")
    log(f"[cons] stream {streamed!r}; async {atexts}")

    # the constrained round once more through an eager generator on the
    # same (now idle) cache: the same tokens
    tot = graph_counts(gen)
    gen = DynamicGenerator(model, cache, tok, max_batch_size=SERVE_JOBS,
                           max_chunk_size=512, decode_burst=16, graphs=False)
    jobs_e = constrained_jobs({14: [], 15: []})
    steps_e, _, dt_e = run_round(jobs_e)
    same_tokens("cons", jobs, jobs_e)
    graphs = graph_line("cons", tot, g_round, dt, dt_e)
    log(f"[cons] constrained round eager in the same run: "
        f"{sum(j.new_tokens for j in jobs_e) / dt_e:.1f} tokens/s in "
        f"{steps_e} steps, against {new / dt:.1f} graphed")
    del gen, cache, model, w
    torch.cuda.empty_cache()
    return {"launches": got, "steps": steps, "rewinds": rewinds,
            "tokens": new, "round_ms": dt * 1e3, "tokens_per_s": new / dt,
            "host_ms_per_step": dt / steps * 1e3, "step_graphs": graphs,
            "tokens_per_s_eager": sum(j.new_tokens for j in jobs_e) / dt_e,
            "texts": [j.emitted_text for j in jobs], "free_texts": texts,
            "stream": streamed, "async": atexts}


# --------------------------------------------------------------- phase 12

SPEC_D = 4              # drafts a speculative round
SPEC_NEW = 64           # new tokens of the n-gram leg
DRAFT_NEW = 32          # of the draft-model legs and the CFG leg
# two exact paths may part at a near-tie: at the first token where a
# speculative (or CFG 1.0) round parts from the plain round, the plain
# round's teacher-forced logits must have a top-2 gap under this share of
# max |logit| (the decode-vs-prefill gate of the logits)
TIE_GAP = 0.02
# StarCoder's decode-vs-prefill gates (decode_vs_prefill), set from the
# readings of `python3 chip_smoke.py dvp-seeds` over DVP_SEEDS (PERF.md
# section 6): kernel 2 swapped for its plain version moved a reading by
# 0.9 % at most, and the highest reading was 9.9e-2
DVP_WITNESS = 0.1
DVP_LIMIT = 0.15
DVP_SEEDS = (2, 3, 4, 5, 6, 7)
LORA_RANK = 16
LORA_TOL = 0.02         # 2-layer cut: each adapted linear vs its f32
                        # product, and the logits vs the f32-bypass forward


def spec_round(gen, prompts, new, **job_kw):
    """Enqueue one greedy job a prompt, iterate to the end: -> (jobs,
    seconds, rounds). A round is an iterate() that emitted tokens (every
    job decodes in one group)."""
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jobs = []
    for i, p in enumerate(prompts):
        kw = {k: v[i] for k, v in job_kw.items()}
        s = Settings.greedy()
        if "negative_prompt_ids" in kw:
            s.cfg_scale = kw.pop("cfg_scale")
        jobs.append(gen.enqueue(DynamicJob(p, max_new_tokens=new,
                                           settings=s, **kw)))
    rounds = 0
    while any(j.status != "done" for j in jobs):
        rounds += any(r["stage"] == "streaming" for r in gen.iterate())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for j in jobs:
        toks = j.sequence[j.prompt_len:]
        if (j.new_tokens != new or j.eos_reason != "max_new_tokens"
                or toks.min() < 0 or toks.max() >= VOCAB):
            raise AssertionError(f"job: {j.new_tokens} tokens, "
                                 f"{j.eos_reason}")
    return jobs, dt, rounds


def decode_rate(jobs, rounds: int):
    """The decode part of a round, from the first token to the last (the
    prefill and the first step or round before it): -> (tokens/s, ms a
    step or round)."""
    t0 = min(j.time_first_token for j in jobs)
    t1 = max(j.time_last_token for j in jobs)
    n = sum(j.new_tokens - 1 for j in jobs)
    return n / (t1 - t0), (t1 - t0) / max(1, rounds - 1) * 1e3


def near_tie(tag, model, plain_jobs, jobs) -> list:
    """Each job's tokens against the plain round's same job: equal, or the
    first differing token falls on a near-tie of the plain round's
    teacher-forced logits (top-2 gap under TIE_GAP of max |logit|), else
    the phase fails. -> the first differing position of each job (None
    where equal) and its gap."""
    out = []
    for a, b in zip(plain_jobs, jobs):
        pa, pb = a.sequence[a.prompt_len:], b.sequence[b.prompt_len:]
        diff = np.nonzero(pa != pb)[0]
        if not diff.size:
            out.append(None)
            continue
        i = int(diff[0])
        lg = teacher_forced_logits(model, a.prompt_ids, pa[:i + 1])[i]
        top = torch.topk(lg.float(), 2).values
        gap = ((top[0] - top[1]) / lg.abs().max()).item()
        log(f"[spec] {tag}: parts from the plain round at new token {i} "
            f"({int(pa[i])} plain, {int(pb[i])} here): top-2 gap "
            f"{gap:.2e} of max |logit| (limit {TIE_GAP})")
        if not gap < TIE_GAP:
            raise AssertionError(f"{tag}: token {i} differs off a near-tie")
        out.append((i, gap))
    return out


def phase_spec(dev):
    """Speculative decoding (n-gram and draft model), CFG and LoRA on the
    serving path at 7B width and full depth, each graphed against eager."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    from exllamav2_tpu_torch.lora import Lora, apply_lora
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.models.modules import ModelWeights
    from exllamav2_tpu_torch.ops.dequant import (
        dequant_linear, precompute_model_scales)
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.testing import (
        random_model_weights, write_random_lora)
    w, st = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 heads=HEADS, kv_heads=HEADS, inter=INTER,
                                 max_seq=2048, bits=4, seed=0, device=dev)
    w = precompute_model_scales(w)
    model = Model(w, st)                           # phases 5 and 7's model
    tok = ByteTokenizer(256)        # no EOS id: every job runs all its tokens
    per_step = 7 * LAYERS + 1       # fused linears of a t = 1 step

    def new_cache(layers=LAYERS):
        return PagedKVCache.alloc(layers, SERVE_PAGES, HEADS, HIDDEN // HEADS,
                                  "bf16", device=dev)

    cache = new_cache()

    def new_gen(graphs=True, **kw):
        return DynamicGenerator(model, cache, tok, max_batch_size=SERVE_JOBS,
                                max_chunk_size=512, decode_burst=16,
                                graphs=graphs, **kw)

    def counted(gen, prompts, new, **kw):
        """A warm round, then a measured round with its launch counts and
        verify replays. -> (jobs, seconds, rounds, counts, replays)."""
        spec_round(gen, prompts, new, **kw)
        zero_counts()
        before = dict(gen.step_graphs.replays)
        jobs, dt, rounds = spec_round(gen, prompts, new, **kw)
        got = launch_counts()
        replays = {k[0]: 0 for k in gen.step_graphs.replays}
        for k, n in gen.step_graphs.replays.items():
            replays[k[0]] += n - before.get(k, 0)
        return jobs, dt, rounds, got, replays

    def check_counts(tag, got, want):
        want = dict({"qmm_w4a8": 0, "qmm_partials": 0, "decode_attn": 0},
                    **want)
        got = {k: got[k] for k in want}
        log(f"[spec] {tag}: launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{tag} launch counts {got} != {want}")

    rng = np.random.default_rng(12)
    out, launches = {}, {}

    # --- leg 1: n-gram speculative, batch 1: a 16-token pattern 8 times
    prompt1 = [np.tile(rng.integers(3, 250, 16).astype(np.int32), 8)]
    plain_gen = new_gen()
    plain_jobs, dt_plain, _ = spec_round(plain_gen, prompt1, SPEC_NEW)
    plain_jobs, dt_plain, _ = spec_round(plain_gen, prompt1, SPEC_NEW)
    gen = new_gen(use_ngram_draft=True, num_draft_tokens=SPEC_D)
    jobs, dt, rounds, got, replays = counted(gen, prompt1, SPEC_NEW)
    check_counts("n-gram b1", got, {"qmm": per_step * rounds,
                                    "paged_decode_attn": 0})
    if replays.get("verify") != rounds:
        raise AssertionError(f"n-gram: {replays} for {rounds} rounds")
    launches["spec_ngram_b1"] = got
    jobs_e, _, _ = spec_round(new_gen(False, use_ngram_draft=True,
                                      num_draft_tokens=SPEC_D),
                              prompt1, SPEC_NEW)
    same_tokens("spec n-gram", jobs, jobs_e)
    ties = near_tie("n-gram b1", model, plain_jobs, jobs)
    acc = jobs[0].draft_accepted
    tps, ms_round = decode_rate(jobs, rounds)
    tps_plain, ms_step = decode_rate(plain_jobs, SPEC_NEW)
    log(f"[spec] n-gram b1: decode {tps:.1f} tokens/s against "
        f"{tps_plain:.1f} plain (decode_burst 16, same run; first token to "
        f"last); {rounds} rounds, {acc / rounds:.2f} accepted drafts a "
        f"round, {ms_round:.2f} ms of host clock a round ({ms_step:.2f} a "
        f"plain step); whole rounds with the prefill {SPEC_NEW / dt:.1f} "
        f"against {SPEC_NEW / dt_plain:.1f} tokens/s")
    if acc <= 0:
        raise AssertionError("n-gram: no draft accepted")
    out["ngram_b1"] = {"tokens_per_s": tps, "plain_tokens_per_s": tps_plain,
                       "round_tokens_per_s": SPEC_NEW / dt,
                       "plain_round_tokens_per_s": SPEC_NEW / dt_plain,
                       "rounds": rounds, "accepted": acc,
                       "ms_per_round": ms_round, "ms_per_plain_step": ms_step,
                       "ties": ties}
    del gen, plain_gen

    # --- leg 2: draft-model speculative at batch 1 and 4: (a) the model as
    # its own draft, (b) a 2-layer random draft of another seed
    dw, dst = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=2,
                                   heads=HEADS, kv_heads=HEADS, inter=INTER,
                                   max_seq=2048, bits=4, seed=1, device=dev)
    drafts = {"self": (model, LAYERS),
              "2layer": (Model(precompute_model_scales(dw), dst), 2)}
    prompts4 = [rng.integers(3, 250, SERVE_PROMPT).astype(np.int32)
                for _ in range(4)]
    plain_b = {}
    for b, prompts in ((1, prompts4[:1]), (4, prompts4)):
        pg = new_gen()
        spec_round(pg, prompts, DRAFT_NEW)
        plain_jobs, dt_plain, _ = spec_round(pg, prompts, DRAFT_NEW)
        plain_b[b] = plain_jobs
        del pg
        for name, (dm, dl) in drafts.items():
            tag = f"draft {name} b{b}"
            dcache = new_cache(dl)
            gen = new_gen(draft_model=dm, draft_cache=dcache,
                          num_draft_tokens=SPEC_D)
            jobs, dt, rounds, got, replays = counted(gen, prompts, DRAFT_NEW)
            step = per_step if dl == LAYERS else 7 * dl + 1
            check_counts(tag, got, {
                "qmm": rounds * (per_step + SPEC_D * step),
                "paged_decode_attn": rounds * SPEC_D * dl})
            if replays.get("verify") != rounds or \
                    replays.get("draft") != rounds:
                raise AssertionError(f"{tag}: {replays} for {rounds} "
                                     "rounds")
            launches[f"spec_draft_{name}_b{b}"] = got
            del gen
            gen_e = new_gen(False, draft_model=dm, draft_cache=dcache,
                            num_draft_tokens=SPEC_D)
            jobs_e, dt_e, _ = spec_round(gen_e, prompts, DRAFT_NEW)
            del gen_e, dcache
            same_tokens(f"spec {tag}", jobs, jobs_e)
            ties = near_tie(tag, model, plain_jobs, jobs)
            acc = sum(j.draft_accepted for j in jobs)
            tps, ms_round = decode_rate(jobs, rounds)
            tps_plain, ms_step = decode_rate(plain_jobs, DRAFT_NEW)
            tps_e, _ = decode_rate(jobs_e, rounds)
            log(f"[spec] {tag}: decode {tps:.1f} tokens/s against "
                f"{tps_plain:.1f} plain (eager {tps_e:.1f}); {rounds} "
                f"rounds, {acc / rounds:.2f} accepted drafts a round "
                f"({acc / (rounds * b * SPEC_D):.1%} of the drafts), "
                f"{ms_round:.2f} ms of host clock a round ({ms_step:.2f} a "
                f"plain step)")
            out[f"draft_{name}_b{b}"] = {
                "tokens_per_s": tps, "plain_tokens_per_s": tps_plain,
                "eager_tokens_per_s": tps_e, "rounds": rounds,
                "accepted": acc, "ms_per_round": ms_round,
                "ms_per_plain_step": ms_step, "ties": ties}
    del drafts, dw
    torch.cuda.empty_cache()

    # --- leg 3: CFG, 4 jobs with 64-token negative prompts
    negs = [rng.integers(3, 250, 64).astype(np.int32) for _ in range(4)]
    cfg_jobs = {}
    for scale in (1.5, 1.0):
        kw = {"negative_prompt_ids": negs, "cfg_scale": [scale] * 4}
        gen = new_gen()
        jobs, dt, rounds, got, _ = counted(gen, prompts4, DRAFT_NEW, **kw)
        check_counts(f"CFG {scale}", got, {
            "qmm": per_step * DRAFT_NEW,
            "paged_decode_attn": LAYERS * DRAFT_NEW})
        launches[f"cfg_{scale}"] = got
        del gen
        jobs_e, dt_e, _ = spec_round(new_gen(False), prompts4, DRAFT_NEW,
                                     **kw)
        same_tokens(f"cfg {scale}", jobs, jobs_e)
        if any(j.kv_pos2 != 64 + DRAFT_NEW - 1 for j in jobs):
            raise AssertionError("CFG: second-stream positions")
        cfg_jobs[scale] = jobs
        tps, ms_step = decode_rate(jobs, rounds)
        tps_e, ms_e = decode_rate(jobs_e, rounds)
        log(f"[spec] CFG {scale}: decode {tps:.1f} tokens/s, {ms_step:.2f} "
            f"ms a paired step of 8 rows (eager {tps_e:.1f}, {ms_e:.2f} "
            f"ms); {rounds} steps; with the 8 single-stream prefills "
            f"{4 * DRAFT_NEW / dt:.1f} tokens/s")
        out[f"cfg_{scale}"] = {"tokens_per_s": tps, "ms_per_step": ms_step,
                               "eager_tokens_per_s": tps_e,
                               "round_tokens_per_s": 4 * DRAFT_NEW / dt}
    # at scale 1 the mix is the conditional log-probabilities
    out["cfg_1.0"]["ties"] = near_tie("CFG 1.0", model, plain_b[4],
                                      cfg_jobs[1.0])

    # --- leg 4: LoRA, rank 16 on q/k/v/o and gate/up/down
    lora_dir = write_random_lora(os.path.join(OUT_DIR, "lora_7b"), w,
                                 rank=LORA_RANK, alpha=2.0 * LORA_RANK,
                                 scale=0.02, seed=3)
    lora = Lora(lora_dir)
    served = serve_prompts(rng)
    for merged in (False, True):
        tag = "LoRA merged" if merged else "LoRA"
        gen = new_gen(merged_weights=merged)
        base, new, dt_base = serve_round(gen, served)
        if not merged:                   # warm: the first round captures
            base, new, dt_base = serve_round(gen, served)
        gen.set_loras([lora])
        if not merged:
            serve_round(gen, served)
        zero_counts()
        adapted, _, dt = serve_round(gen, served)
        got = launch_counts()
        check_counts(tag, got, {"qmm": per_step * SERVE_NEW,
                                "paged_decode_attn": LAYERS * SERVE_NEW})
        launches["serving16_lora_merged" if merged
                 else "serving16_lora"] = got
        gen.set_loras(None)
        restored, _, _ = serve_round(gen, served)
        del gen
        same_tokens(f"{tag} detached", restored, base)
        moved = sum(a.sequence.tolist() != b.sequence.tolist()
                    for a, b in zip(adapted, base))
        log(f"[spec] {tag}: the adapter moves {moved} of {SERVE_JOBS} jobs")
        if not moved:
            raise AssertionError(f"{tag}: the adapter changed no token")
        if merged:
            same_tokens("LoRA merged vs unmerged", adapted, adapted_unmerged)
            continue
        adapted_unmerged = adapted
        gen_e = new_gen(False)
        gen_e.set_loras([lora])
        adapted_e, _, dt_e = serve_round(gen_e, served)
        del gen_e
        same_tokens("LoRA", adapted, adapted_e)
        log(f"[spec] LoRA rank {LORA_RANK}: serving16 {new / dt:.1f} "
            f"tokens/s adapted against {new / dt_base:.1f} unadapted (warm "
            f"rounds, same run; eager adapted {new / dt_e:.1f})")
        out["lora"] = {"tokens_per_s": new / dt,
                       "base_tokens_per_s": new / dt_base,
                       "eager_tokens_per_s": new / dt_e, "moved": moved}
    del cache
    torch.cuda.empty_cache()

    # a 2-layer cut: the adapted logits of graphed t = 1 steps against the
    # same forward with every bypass in f32 (plain torch), and every adapted
    # linear of that pass against the f32 product x @ W + s * (x @ A) @ B on
    # the same input
    cut = ModelWeights(w.embed, list(w.layers[:2]), w.final_norm, w.head,
                       w.sin, w.cos)
    st2 = dataclasses.replace(st, num_layers=2, layers=st.layers[:2])
    m2 = Model(apply_lora(cut, lora), st2)
    seq = rng.integers(3, 250, 24).astype(np.int32)
    lc = m2.new_cache(1, 256)
    lg, lc = m2.forward(seq[None, :8], lc, 0, last_token_only=True)
    got = [lg[0, -1].float().cpu()]
    for i in range(8, len(seq) - 1):
        lg, lc = m2.forward(seq[None, i:i + 1], lc, i)
        got.append(lg[0, -1].float().cpu())
    linear_apply = F.linear_apply
    dense, calls = {}, []

    def f32_bypass(x, lin, **kw):
        if not hasattr(lin, "base"):
            return linear_apply(x, lin, **kw)
        return linear_apply(x, lin.base, **kw) + lin.scaling * (
            (x.float() @ lin.a.float()) @ lin.b.float())

    def held(x, lin, **kw):
        y = linear_apply(x, lin, **kw)
        if hasattr(lin, "base"):
            if id(lin) not in dense:
                dense[id(lin)] = dequant_linear(lin.base, torch.float32)
            xf = x.float()
            ref = xf @ dense[id(lin)] + lin.scaling * (
                (xf @ lin.a.float()) @ lin.b.float())
            calls.append(((y - ref).abs().max() / ref.abs().max()).item())
        return y

    try:
        F.linear_apply = f32_bypass
        ref = teacher_forced_logits(m2, seq[:8], seq[8:])
        F.linear_apply = held
        teacher_forced_logits(m2, seq[:8], seq[8:])
    finally:
        F.linear_apply = linear_apply
    logits_rel = max(((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(got, ref))
    lora_rel = max(calls)
    log(f"[spec] LoRA 2-layer cut: {len(calls)} adapted linears against "
        f"the f32 product on the same input: max rel err {lora_rel:.2e} "
        f"(limit {LORA_TOL}); logits of {len(got)} graphed steps against "
        f"the forward with the bypass in f32: rel err {logits_rel:.2e}")
    if not (lora_rel < LORA_TOL and logits_rel < LORA_TOL):
        raise AssertionError(f"LoRA linears rel err {lora_rel}, logits "
                             f"{logits_rel}")
    out["lora"].update(cut_linear_rel_err=lora_rel,
                       cut_logits_rel_err=logits_rel)
    del m2, lc, dense

    # a weight swap on a model with step graphs (to another seed's
    # weights): graphed against eager
    prompt = prompts4[0][None, :16]
    first = model.generate_greedy(prompt, 16)
    w2, _ = random_model_weights(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 heads=HEADS, kv_heads=HEADS, inter=INTER,
                                 max_seq=2048, bits=4, seed=2, device=dev)
    model.weights = precompute_model_scales(w2)
    swapped = model.generate_greedy(prompt, 16)
    swapped_e = eager(model, lambda: model.generate_greedy(prompt, 16))
    moved = int((swapped != first).sum())
    log(f"[spec] weight swap: graphed tokens equal the eager path's: "
        f"{np.array_equal(swapped, swapped_e)}; the swap moved {moved} of "
        f"16 tokens")
    if not np.array_equal(swapped, swapped_e) or not moved:
        raise AssertionError("weight swap: graphed != eager, or no token "
                             "moved")
    del model, w, w2
    torch.cuda.empty_cache()
    return {"legs": out, "launches": launches}


# --------------------------------------------------------------- phase 13

# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json), full width and depth
MIXTRAL = dict(vocab=32000, hidden=4096, layers=32, heads=32, kv_heads=8,
               inter=14336, moe=8, moe_topk=2, rope_theta=1e6)
# Gemma-3-12B's text model (google/gemma-3-12b-it text_config): SWA 1024,
# every sixth layer global; local theta 10000 (the architecture's), global 1e6
GEMMA3 = dict(vocab=262208, hidden=3840, layers=48, heads=16, kv_heads=8,
              head_dim=256, inter=15360, arch="Gemma3ForCausalLM",
              sliding_window=1024, rope_theta=1e6)
# Command R7B (CohereForAI/c4ai-command-r7b-12-2024) at published width, 4 of
# its 32 layers: SWA 4096 with pattern 4, so layer 3 is a global NoPE layer
COHERE2 = dict(vocab=256000, hidden=4096, layers=4, heads=32, kv_heads=8,
               inter=14336, arch="Cohere2ForCausalLM", sliding_window=4096,
               rope_theta=50000.0)
# GPT-2 (gpt2) at published width, 2 of its 12 layers: learned positions
# (1024 rows), LayerNorm, GELU, an ungated MLP
GPT2 = dict(vocab=50257, hidden=768, layers=2, heads=12, kv_heads=12,
            inter=3072, arch="GPT2LMHeadModel")
# StarCoder-15B (bigcode/starcoder, GPTBigCodeForCausalLM) at published
# width, 2 of its 40 layers: multi-query attention, 48 query heads on one
# KV head (kernels 2 and 3 in one block of three m16 tiles), learned
# positions
STARCODER = dict(vocab=49152, hidden=6144, layers=2, heads=48, kv_heads=1,
                 inter=24576, arch="GPTBigCodeForCausalLM")
MOE_SHAPES = [(4096, 14336), (14336, 4096)]    # Mixtral's w1/w3 and w2
MOE_ROWS = (1, 4, 16)
# the gated decode's logits against the forced-dense formulation's, max
# |diff| / max |dense| (unrouted experts add exact zeros either way; the
# limit is decode-vs-prefill's)
MOE_TOL = 0.02
ARCH_PROMPT, ARCH_NEW = 16, 32


def arch_model(cfg: dict, dev, seed: int = 0, max_seq: int = 2048):
    """Random 4-bit EXL2 weights of `cfg` drawn on the card, prescaled."""
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.ops.dequant import precompute_model_scales
    from exllamav2_tpu_torch.utils.testing import random_model_weights
    t0 = time.perf_counter()
    w, st = random_model_weights(max_seq=max_seq, bits=4, seed=seed,
                                 device=dev, **cfg)
    model = Model(precompute_model_scales(w), st)
    torch.cuda.synchronize()
    gbytes = sum(b.numel() * b.element_size()
                 for b in model.weights.buffers()) / 1e9
    return model, gbytes, time.perf_counter() - t0


def step_launches(model, rows: int) -> dict:
    """Kernel-1 launches of one forward of `rows` rows on the card (all and
    gated), as the forward dispatches them: a linear launches where it runs
    on <= 32 rows; an MoE layer up to 32 rows launches every expert's three
    linears gated, from max(64, 2E) rows its capacity dispatch launches them
    ungated where the capacity is <= 32 rows; a dense head takes no kernel."""
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.models.modules import MoEWeights
    from exllamav2_tpu_torch.ops.qmm import FUSED_MAX_ROWS
    from exllamav2_tpu_torch.quant.qtensor import QuantLinear
    st, w = model.static, model.weights
    fused = rows <= FUSED_MAX_ROWS
    n = gated = 0
    for lw in w.layers:
        a = lw.attn
        n += fused * sum(isinstance(x, QuantLinear)
                         for x in (a.q, a.k, a.v, a.o))
        m = lw.mlp
        if isinstance(m, MoEWeights):
            e3 = 3 * st.num_experts
            if fused:
                n += e3
                gated += e3
            elif rows >= max(F._MOE_DISPATCH_MIN_TOKENS[0],
                             2 * st.num_experts):
                cap = int(np.ceil(rows * st.num_experts_per_tok
                                  * F._MOE_CAPACITY_FACTOR[0]
                                  / st.num_experts))
                cap = min(-(-cap // 8) * 8, rows)
                n += e3 * (cap <= FUSED_MAX_ROWS)
        else:
            n += fused * sum(isinstance(x, QuantLinear)
                             for x in (m.gate, m.up, m.down))
    return {"qmm": n, "qmm_gated": gated}


def head_launches(model) -> int:
    from exllamav2_tpu_torch.quant.qtensor import QuantLinear
    return int(isinstance(model.weights.head, QuantLinear))


def greedy_want(model, b: int, t0: int, new: int) -> dict:
    """The launches of generate_greedy(b x t0 prompt, new): the prefill's
    (with the head on its last token) and new - 1 one-token steps."""
    pre = step_launches(model, b * t0)
    dec = step_launches(model, b)
    hd = head_launches(model)
    steps = new - 1
    return {"qmm": pre["qmm"] + hd + (dec["qmm"] + hd) * steps,
            "qmm_gated": pre["qmm_gated"] + dec["qmm_gated"] * steps,
            "decode_attn": model.static.num_layers * steps}


def arch_counts() -> dict:
    from exllamav2_tpu_torch.ops import qmm as Q
    c = launch_counts()
    return {"qmm": c["qmm"], "qmm_gated": Q.GATED_LAUNCHES["qmm_gated"],
            "decode_attn": c["decode_attn"],
            "paged_decode_attn": c["paged_decode_attn"]}


def arch_greedy(tag, model, prompt, new, vocab) -> dict:
    """generate_greedy graphed with its launch counts (zeroed just before,
    read just after) against greedy_want, then the same call eager: bitwise
    the same tokens."""
    b, t0 = prompt.shape
    want = dict(greedy_want(model, b, t0, new), paged_decode_attn=0)
    for _ in range(2):      # warm-up: a prefill key captures at its 2nd
        model.generate_greedy(prompt, 2)
    torch.cuda.synchronize()
    zero_counts()
    g0 = graph_counts(model)
    t = time.perf_counter()
    seq = model.generate_greedy(prompt, new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = arch_counts()
    graphs = graph_counts(model, g0)
    log(f"[{tag}] generate_greedy b{b}: launches {got} (expected {want}); "
        f"step graphs {graphs}")
    no_captures(f"{tag} generate_greedy b{b}", graphs)
    if got != want:
        raise AssertionError(f"{tag} b{b} launch counts {got} != {want}")
    if (seq.shape != (b, t0 + new) or seq.min() < 0 or seq.max() >= vocab
            or graphs["replays"] != new - 1):
        raise AssertionError(f"{tag} b{b}: bad generation {seq.shape}, "
                             f"{graphs}")
    t = time.perf_counter()
    seq_e = eager(model, lambda: model.generate_greedy(prompt, new))
    dt_e = time.perf_counter() - t
    same = np.array_equal(seq, seq_e)
    log(f"[{tag}] b{b}: graphed tokens equal the eager path's: {same} "
        f"({dt:.2f} s graphed, {dt_e:.2f} s eager, prefill included)")
    if not same:
        raise AssertionError(f"{tag} b{b}: graphed {seq.tolist()} != eager "
                             f"{seq_e.tolist()}")
    return {"launches": got, "tokens": seq[:, t0:].tolist(),
            "step_graphs": graphs, "seconds": dt, "seconds_eager": dt_e}


def dvp_readings(model, prompt, plain=()) -> tuple[float, float]:
    """One-token steps against the prefill of the same prompt, max |diff| /
    max |prefill|, twice: as served, and with the prefill's attention
    probabilities kept in f32 (its t > 1 product rounds them to bf16, the
    reference's rounding point; the one-token kernel keeps them in f32).
    Kernels named in `plain` (1: the fused dequant-matmul, 2: decode
    attention) are swapped for their plain versions, the steps then eager
    (a graph holds the kernels it captured)."""
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.ops import decode_attn as A
    from exllamav2_tpu_torch.ops import qmm as Q

    def rel_err():
        full, _ = model.forward(prompt, model.new_cache(1, 64), 0)
        cache = model.new_cache(1, 64)
        step = []
        for i in range(prompt.shape[1]):
            lg, cache = model.forward(prompt[:, i:i + 1], cache, i)
            step.append(lg[:, 0])
        step = torch.stack(step, 1)
        if not torch.isfinite(full).all():
            raise AssertionError("non-finite prefill logits")
        return ((step - full).abs().max() / full.abs().max()).item()

    def both():
        rel = rel_err()
        F.gqa_values = lambda p, v: torch.einsum("bkgts,bksd->btkgd",
                                                 p.float(), v.float())
        return rel, rel_err()

    real = F.gqa_values, F.decode_attention, Q.fused_segment_matmul
    if 1 in plain:
        Q.fused_segment_matmul = lambda x, seg, gate=None: Q.qmm_plain(x, seg)
    if 2 in plain:
        F.decode_attention = A.decode_attention_plain
    try:
        return eager(model, both) if plain else both()
    finally:
        F.gqa_values, F.decode_attention, Q.fused_segment_matmul = real


def decode_vs_prefill(tag, model, prompt, production_gate=True,
                      witness=False) -> dict:
    """dvp_readings as served: the f32 one isolates the cache, the
    positions and the masks, and must be < 0.02; so must the served one
    where production_gate (Gemma-3's 48 random layers amplify the rounding
    past it: PERF.md section 6). With `witness` (StarCoder: its two random
    GPTBigCode layers amplify kernel 1's rounding to 4e-2 - 1e-1, and the
    plain versions' to 2e-3 - 9e-2, over the seeds of dvp_seeds) each
    reading must instead be under DVP_LIMIT and within DVP_WITNESS of
    itself of the reading on the same weights with kernel 2, which reads
    the cache, swapped for its plain version."""
    rel, rel_f32 = dvp_readings(model, prompt)
    log(f"[{tag}] decode vs prefill logits rel err {rel:.2e} as served, "
        f"{rel_f32:.2e} with the prefill's probabilities in f32")
    out = {"served": rel, "f32_probabilities": rel_f32}
    if witness:
        out["plain_2"] = dvp_readings(model, prompt, (2,))
        moved = [abs(a - b) / b for a, b in zip((rel, rel_f32),
                                                 out["plain_2"])]
        log(f"[{tag}] the same with kernel 2 swapped for its plain version: "
            f"{out['plain_2'][0]:.2e} as served, {out['plain_2'][1]:.2e} "
            f"with f32 probabilities; kernel 2 moves them by {moved[0]:.1%} "
            f"and {moved[1]:.1%} (limit {DVP_WITNESS:.0%}); the limit on "
            f"both readings is {DVP_LIMIT}")
        if not (max(rel, rel_f32) < DVP_LIMIT and max(moved) <= DVP_WITNESS):
            raise AssertionError(f"{tag}: decode vs prefill rel err {rel}, "
                                 f"{rel_f32} with f32 probabilities, "
                                 f"{out['plain_2']} with kernel 2's plain "
                                 f"version")
    elif not (rel_f32 < 0.02 and (rel < 0.02 or not production_gate)):
        raise AssertionError(f"{tag}: decode vs prefill rel err {rel}, "
                             f"{rel_f32} with f32 probabilities")
    return out


def dvp_seeds(dev) -> dict:
    """`python3 chip_smoke.py dvp-seeds`: StarCoder-15B width (phase 13c's
    2 layers and prompt) at seeds DVP_SEEDS, dvp_readings with the kernels,
    with both swapped for their plain versions, and with one swapped at a
    time: the spread that sets DVP_WITNESS and DVP_LIMIT."""
    import gc
    p1 = np.random.default_rng(5).integers(3, 32000, (1, ARCH_PROMPT))
    prompt = (p1 % STARCODER["vocab"]).astype(np.int32)
    out = {}
    for seed in DVP_SEEDS:
        model = arch_model(STARCODER, dev, seed=seed)[0]
        r = {name: dvp_readings(model, prompt, swap) for name, swap in
             (("kernels", ()), ("plain", (1, 2)), ("plain_1", (1,)),
              ("plain_2", (2,)))}
        log(f"[dvp-seeds] seed {seed}: " + ", ".join(
            f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in r.items())
            + f"; kernels / plain {r['kernels'][0] / r['plain'][0]:.2f}")
        out[seed] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def attention_f64(q, k, v, layer, past_len, limit, scale, softcap=0.0,
                  window=0) -> torch.Tensor:
    """decode_attention's function evaluated in f64 (ops/decode_attn.py's
    plain formula: the scores, the exp / sum softmax and the weighted sum
    of V) on the same bf16 inputs: the exact value the kernel and the f32
    plain version both approximate."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    kk = k[layer, :, :, :limit].double()
    vv = v[layer, :, :, :limit].double()
    sc = torch.einsum("bhgd,bhld->bhgl",
                      q.double().reshape(b, hkv, hq // hkv, d), kk) * scale
    if softcap > 0.0:
        sc = torch.tanh(sc * (1.0 / softcap)) * softcap
    pos = torch.arange(limit, device=q.device)
    if isinstance(past_len, torch.Tensor):
        past_len = past_len.long().reshape(-1, 1, 1, 1)
    valid = pos <= past_len
    if window > 0:
        valid = valid & (pos > past_len - window)
    p = torch.softmax(torch.where(valid, sc, torch.full_like(sc, -1e300)),
                      -1)
    return torch.einsum("bhgl,bhld->bhgd", p, vv).reshape(b, hq, d)


def starcoder_held(model, dev, prompt) -> dict:
    """Kernel 2 held on the path's own inputs: every launch of an eager
    generate_greedy call against the f64 evaluation of its function on the
    same inputs (within ATTN_TOL of max |v| in the layer's cache, the gate
    phase 3 holds it to against the plain version), and against the f32
    plain version within ATTN_TOL plus that launch's distance of the plain
    version from the f64 evaluation. On these random layers the scores
    reach ~4e4 with runner-ups ~2 below the max, where the f32 plain
    version is itself up to 1.8e-4 of max |v| from that value (PERF.md).
    Every launch's three distances are logged. Then kernels 1 and 3 under
    held_kernels through an eager generator job (kernel 3 within
    ATTN_PATH_TOL). Decode against prefill is held by decode_vs_prefill
    (DVP_LIMIT, DVP_WITNESS)."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import (
        DynamicGenerator, DynamicJob)
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.ops import decode_attn as A
    real, launches = F.decode_attention, []

    def k2_held(q, k, v, layer, past_len, limit, scale, softcap=0.0,
                window=0):
        got = real(q, k, v, layer, past_len, limit, scale, softcap, window)
        exact = attention_f64(q, k, v, layer, past_len, limit, scale,
                              softcap, window)
        plain = A.decode_attention_plain(q, k, v, layer, past_len, limit,
                                         scale, softcap, window)
        vmax = v[layer].double().abs().max()
        launches.append({key: ((a.double() - b.double()).abs().max()
                               / vmax).item()
                         for key, a, b in (("exact", got, exact),
                                           ("plain_exact", plain, exact),
                                           ("plain", got, plain))})
        launches[-1]["layer"] = layer
        return got

    F.decode_attention = k2_held
    try:
        eager(model, lambda: model.generate_greedy(prompt, 8))
    finally:
        F.decode_attention = real
    st = model.static
    gen = DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 4, st.num_kv_heads, st.head_dim, device=dev),
        id_tokenizer(), graphs=False)
    with held_kernels("starcoder") as held:
        job = gen.enqueue(DynamicJob(prompt[0], max_new_tokens=8,
                                     settings=Settings.greedy()))
        while job.status != "done":
            gen.iterate()
    worst3 = max(held["paged"].values(), default=None)
    worst = {key: max((r[key] for r in launches), default=0.0)
             for key in ("exact", "plain_exact", "plain")}
    log(f"[starcoder] kernel 2 held on {len(launches)} launches of the "
        f"greedy path at {st.num_heads}/{st.num_kv_heads} heads, of max |v| "
        f"(kernel from f64 / f32 plain from f64 / kernel from plain, "
        f"layer): "
        + ", ".join(f"{r['exact']:.2e} / {r['plain_exact']:.2e} / "
                    f"{r['plain']:.2e} L{r['layer']}" for r in launches)
        + f"; worst {worst['exact']:.2e} / {worst['plain_exact']:.2e} / "
        f"{worst['plain']:.2e}; kernel 3 held at {sorted(held['paged'])} "
        f"(worst {worst3}), kernel 1 at {len(held['qmm'])} shapes")
    if not (launches and held["paged"] and held["qmm"] and all(
            r["exact"] <= ATTN_TOL
            and r["plain"] <= ATTN_TOL + r["plain_exact"]
            for r in launches)):
        raise AssertionError(f"starcoder: kernel 2 launches {launches}; "
                             f"held {held}")
    return {"kernel2_launches": len(launches),
            "kernel2_worst": worst["exact"],
            "kernel2_plain_worst": worst["plain"],
            "plain_f32_worst": worst["plain_exact"],
            "kernel2_by_launch": launches,
            "kernel3_worst": worst3, "qmm_shapes": len(held["qmm"])}


def decode_rate_b1(model, prompt, n: int) -> tuple[float, float]:
    """ms a batch-1 token of generate_greedy, graphed and eager: a call
    for 1 + n new tokens less a call for 1 (prefill only), over n (the
    eager one on n // 4 tokens)."""
    def wall(n_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate_greedy(prompt, n_new)
        return time.perf_counter() - t

    ms = (min(wall(1 + n) for _ in range(2)) - min(wall(1) for _ in
                                                  range(3))) / n * 1e3
    ne = max(4, n // 4)
    ms_e = eager(model, lambda: (wall(1 + ne) - min(wall(1) for _ in
                                                    range(2))) / ne * 1e3)
    return ms, ms_e


def arch_serving(tag, model, dev, vocab, drops=False) -> dict:
    """PERF.md's serving16 round: a warm round, a measured round with its
    launch counts asserted (and its prefills timed), one profiled round,
    the measured prompts again through an eager generator (prefills timed)
    and once more under the profiler: the same tokens, p50 TTFT and the
    idle share graphed and eager."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    st = model.static
    tok = ByteTokenizer(256)        # no EOS id: every job runs all its tokens
    cache = PagedKVCache.alloc(st.num_layers, SERVE_PAGES, st.num_kv_heads,
                               st.head_dim, "bf16", device=dev)

    def new_gen(graphs):
        return DynamicGenerator(model, cache, tok, max_batch_size=SERVE_JOBS,
                                max_chunk_size=512, decode_burst=16,
                                graphs=graphs)

    gen = new_gen(True)
    rng = np.random.default_rng(13)
    serve_round(gen, serve_prompts(rng))                 # warm round
    round_prompts = serve_prompts(rng)
    zero_counts()
    g0 = graph_counts(gen)
    with PrefillTimer(gen) as pt:
        jobs, new, dt = serve_round(gen, round_prompts)
    got = arch_counts()
    g_round = graph_counts(gen, g0)
    no_captures(f"{tag} serving16", g_round)
    dec = step_launches(model, SERVE_JOBS)
    hd = head_launches(model)
    # the batched 16 x 128-row prefill launches what step_launches says of
    # 2048 rows and skips the head; then SERVE_NEW one-token steps
    pre = step_launches(model, SERVE_JOBS * SERVE_PROMPT)
    want = {"qmm": pre["qmm"] + (dec["qmm"] + hd) * SERVE_NEW,
            "qmm_gated": pre["qmm_gated"] + dec["qmm_gated"] * SERVE_NEW,
            "decode_attn": 0,
            "paged_decode_attn": st.num_layers * SERVE_NEW}
    log(f"[{tag}] serving16 launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{tag} serving16 launch counts {got} != {want}")
    tps, p50, _ = check_round(f"{tag} serving16", jobs, new, dt, vocab)
    dlv = delivered_p50(jobs)
    dropped = gen.moe_dropped_tokens
    log(f"[{tag}] serving16: {new} tokens in {dt * 1e3:.1f} ms = "
        f"{tps:.1f} tokens/s, p50 TTFT {p50:.1f} ms, first token delivered "
        f"at p50 {dlv:.1f} ms; dropped MoE routes {dropped}")
    if drops and dropped:
        log(f"[{tag}] serving16: the prefill dispatch dropped {dropped} "
            f"routes (capacity factor 2)")
    prof = {}

    def profiled(g):
        prof["out"] = serve_round(g, serve_prompts(rng))
    per, busy, dt_prof = profile_round(lambda: profiled(gen))
    p50_prof = check_round(f"{tag} profiled", *prof["out"], vocab)[1]
    top = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    for name, (t, c) in top:
        log(f"[{tag}] serving16 profile: {t:8.2f} ms {c:6d}x  {name[:70]}")
    pkeys = prefill_keys(tag, gen)
    del gen
    gen_e = new_gen(False)
    with PrefillTimer(gen_e) as pt_e:
        jobs_e, new_e, dt_e = serve_round(gen_e, round_prompts)
    same_tokens(tag, jobs, jobs_e)
    p50_e = check_round(f"{tag} eager", jobs_e, new_e, dt_e, vocab)[1]
    _, busy_e, dt_prof_e = profile_round(lambda: profiled(gen_e))
    p50_prof_e = check_round(f"{tag} eager profiled", *prof["out"], vocab)[1]
    idle = 1 - busy / (dt_prof * 1e3)
    idle_e = 1 - busy_e / (dt_prof_e * 1e3)
    log(f"[{tag}] serving16 device busy {busy:.1f} ms of the profiled "
        f"{dt_prof * 1e3:.1f} ms round (idle share {idle:.1%}; eager "
        f"{busy_e:.1f} of {dt_prof_e * 1e3:.1f}, {idle_e:.1%}; p50 TTFT "
        f"under the profiler {p50_prof:.1f} ms graphed, {p50_prof_e:.1f} "
        f"eager); eager {new_e / dt_e:.1f} tokens/s against {tps:.1f} "
        f"graphed; step graphs {g_round}")
    dlv_e = delivered_p50(jobs_e)
    pl = prefill_line(tag, pt.summary(), pt_e.summary(), (p50, p50_e),
                      (idle, idle_e), (dlv, dlv_e))
    del gen_e, cache
    return {"launches": got, "tokens_per_s": tps, "round_ms": dt * 1e3,
            "p50_ttft_ms": p50, "tokens_per_s_eager": new_e / dt_e,
            "p50_ttft_ms_eager": p50_e, "p50_ttft_ms_profiled": p50_prof,
            "p50_delivered_ms": dlv, "p50_delivered_ms_eager": dlv_e,
            "p50_ttft_ms_profiled_eager": p50_prof_e,
            "device_busy_ms": busy, "profiled_round_ms": dt_prof * 1e3,
            "device_busy_ms_eager": busy_e,
            "profiled_round_ms_eager": dt_prof_e * 1e3,
            "idle_share": idle, "idle_share_eager": idle_e,
            "moe_dropped_tokens": dropped, "prefill": pl,
            "prefill_keys": pkeys, "step_graphs": g_round,
            "top_kernels": [(k[:70], t, c) for k, (t, c) in top]}


def moe_gate_check(dev, rate) -> tuple[list, float]:
    """Kernel 1's gated entry against its plain version at Mixtral's expert
    shapes (4-bit EXL2, prescaled), m in MOE_ROWS, the flag on and off:
    within QMM_TOL of max |plain| on, exact zeros off. Timed like phase 2
    (weights cycled past the L2); off, the launch writes zeros only."""
    from exllamav2_tpu_torch.ops import qmm as Q
    from exllamav2_tpu_torch.ops.dequant import dequant_linear
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    rows, worst = [], 0.0
    for k, n in MOE_SHAPES:
        def make():
            return make_linear("exl2_4b_prescaled", k, n, gen, dev)
        one = make()
        copies = [one] + [make() for _ in range(
            max(1, -(-2 * L2_BYTES // linear_bytes(one, 0))) - 1)]
        wdense = dequant_linear(one, torch.bfloat16, original_order=False)
        for m in MOE_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            for on in (1, 0):
                gate = torch.tensor([on], dtype=torch.int32, device=dev)
                seg = one.segments[0]
                got = Q.fused_segment_matmul(x, seg, gate)
                ref = Q.qmm_gated_plain(x, seg, gate)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                if on:
                    scale = ref.abs().max().item()
                    if not (torch.isfinite(got).all()
                            and err <= QMM_TOL * scale):
                        raise AssertionError(f"gated {k}x{n} m={m}: err "
                                             f"{err} of {scale}")
                elif not torch.equal(got, torch.zeros_like(got)):
                    raise AssertionError(f"gated off {k}x{n} m={m}: not "
                                         "zeros")
                worst = max(worst, err)
                ms = graph_ms([(lambda c=c: Q.fused_segment_matmul(
                    x, c.segments[0], gate)) for c in copies], 40)
                plain_ms = eager_ms(lambda: Q.qmm_gated_plain(x, seg, gate),
                                    3)
                lib_ms = graph_ms([lambda: torch.matmul(x, wdense)], 40) \
                    if on else None
                nbytes = linear_bytes(one, m) if on else m * n * 4 + 4
                rows.append(dict(k=k, n=n, m=m, on=bool(on),
                                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bytes=nbytes,
                                 bound_ms=nbytes / rate * 1e3))
                log(f"[moe] gated kernel {k:5d}x{n:5d} m={m:2d} "
                    f"gate={'on ' if on else 'off'} err={err:.2e} "
                    f"kernel={ms * 1e3:7.1f}us plain={plain_ms * 1e3:8.1f}us"
                    f" bound={nbytes / rate * 1e6:6.1f}us"
                    + (f" lib={lib_ms * 1e3:6.1f}us" if lib_ms else ""))
        del copies, wdense
        torch.cuda.empty_cache()
    return rows, worst


def moe_routed(model, prompt, new) -> list:
    """Experts switched on per layer, for each forward of an eager
    generate_greedy (the gated decode's flags, collected on the device and
    read back after the call): [forwards][layers]."""
    from exllamav2_tpu_torch.models import forward as F
    F._MOE_GATES[0] = []
    try:
        eager(model, lambda: model.generate_greedy(prompt, new))
        gates = torch.stack(F._MOE_GATES[0]).sum(dim=1).cpu().numpy()
    finally:
        F._MOE_GATES[0] = None
    return gates.reshape(-1, model.static.num_layers).tolist()


def phase_archs(dev, rate):
    """Phase 13: Mixtral-8x7B at full width and depth (the gated MoE
    decode), Gemma-3-12B's text model at full width and depth, and Command
    R7B and GPT-2 layers at published width: each model path graphed and
    once eager (bitwise the same tokens), launch counts asserted."""
    import gc
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.ops import qmm as Q
    t_all = time.perf_counter()
    out = {"launches": {}}
    rng = np.random.default_rng(5)

    # --- the gated kernel at Mixtral's expert shapes
    out["gate_rows"], out["gate_err"] = moe_gate_check(dev, rate)

    # --- 13a Mixtral-8x7B
    t0 = time.perf_counter()
    model, gbytes, t_build = arch_model(MIXTRAL, dev)
    st = model.static
    log(f"[mixtral] weights built on {dev} in {t_build:.1f} s, "
        f"{gbytes:.2f} GB")
    p1 = rng.integers(3, 32000, (1, ARCH_PROMPT)).astype(np.int32)
    p4 = rng.integers(3, 32000, (4, ARCH_PROMPT)).astype(np.int32)
    mix = {}
    for name, p in (("b1", p1), ("b4", p4)):
        mix[name] = arch_greedy("mixtral", model, p, ARCH_NEW, 32000)
        out["launches"][f"mixtral_generate_greedy_{name}"] = \
            mix[name]["launches"]
    routed = {name: moe_routed(model, p, 8) for name, p in
              (("b1", p1), ("b4", p4))}
    # forward 0 is the prefill; the rest are one-token steps
    dec_routed = {k: float(np.mean(v[1:])) for k, v in routed.items()}
    log(f"[mixtral] experts switched on per layer per decode step: "
        f"b1 {dec_routed['b1']:.2f}, b4 {dec_routed['b4']:.2f} of "
        f"{st.num_experts} (prefill of 16 rows: b1 "
        f"{np.mean(routed['b1'][0]):.2f})")
    rel = decode_vs_prefill("mixtral", model, p1)
    ms, ms_e = decode_rate_b1(model, p1, 64)
    prof = profile_decode(model, p1)
    busy = prof["device_ms_per_token"]
    k1 = sum(t for n, t, _ in prof["kernels"] if "qmm_kernel" in n)
    # the bytes a batch-1 token must move: q, k, v, o, the routed
    # experts' three linears (dec_routed of them a layer) and the head
    lw = model.weights.layers[0]
    attn_b = sum(linear_bytes(x, 1) for x in
                 (lw.attn.q, lw.attn.k, lw.attn.v, lw.attn.o))
    exp_b = sum(linear_bytes(x[0], 1) for x in (lw.mlp.w1, lw.mlp.w2,
                                                 lw.mlp.w3))
    floor_b = (st.num_layers * (attn_b + dec_routed["b1"] * exp_b)
               + linear_bytes(model.weights.head, 1))
    floor_ms = floor_b / rate * 1e3
    log(f"[mixtral] decode batch 1: {1e3 / ms:.2f} tokens/s ({ms:.3f} ms a "
        f"token graphed, {ms_e:.3f} eager); device busy {busy:.3f} ms a "
        f"token (idle share {1 - busy / ms:.1%}), "
        f"{prof['device_launches_per_token']:.0f} launches a token; kernel 1 "
        f"{k1:.3f} ms a token against the routed-bytes floor "
        f"{floor_ms:.3f} ms ({floor_b / 1e9:.2f} GB)")
    k2 = sum(t for n, t, _ in prof["kernels"] if "decode_attn" in n)
    rest_n = (prof["device_launches_per_token"] - st.num_layers
              - step_launches(model, 1)["qmm"] - head_launches(model))
    log(f"[mixtral] profile: kernel 2 {k2:.3f} ms a token; everything else "
        f"(router, top-k, the experts' act * up, casts, routing-weight "
        f"scales and adds, norms, rope, residuals) {busy - k1 - k2:.3f} ms "
        f"in {rest_n:.0f} launches a token")
    for name, t in prof["top"]:
        log(f"[mixtral] profile: {t:6.3f} ms/token  {name}")
    # the gated decode against the dense formulation, teacher-forced on the
    # b1 tokens (both eager)
    toks = np.asarray(mix["b1"]["tokens"][0])
    g0 = Q.GATED_LAUNCHES["qmm_gated"]
    sparse_lg = teacher_forced_logits(model, p1[0], toks)
    g1 = Q.GATED_LAUNCHES["qmm_gated"]
    F._FORCE_DENSE_MOE[0] = True
    try:
        dense_lg = teacher_forced_logits(model, p1[0], toks)
    finally:
        F._FORCE_DENSE_MOE[0] = False
    if not (g1 > g0 and Q.GATED_LAUNCHES["qmm_gated"] == g1):
        raise AssertionError("mixtral: the dense pass launched gated "
                             "kernels, or the gated pass none")
    moe_rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(sparse_lg, dense_lg))
    parts = [i for i, (a, b) in enumerate(zip(sparse_lg, dense_lg))
             if int(a.argmax()) != int(b.argmax())]
    for i in parts:
        top = torch.topk(dense_lg[i].float(), 2).values
        gap = ((top[0] - top[1]) / dense_lg[i].abs().max()).item()
        if not gap < TIE_GAP:
            raise AssertionError(f"mixtral: gated and dense argmax differ "
                                 f"at step {i} off a near-tie ({gap:.2e})")
    log(f"[mixtral] gated vs forced-dense decode logits rel err "
        f"{moe_rel:.2e} over {len(dense_lg)} steps; argmax parts at "
        f"{parts} (near-ties only)")
    if not moe_rel < MOE_TOL:
        raise AssertionError(f"mixtral gated vs dense rel err {moe_rel}")
    serve = arch_serving("mixtral", model, dev, 32000, drops=True)
    out["launches"]["mixtral_serving16"] = serve["launches"]
    out["mixtral"] = {
        "weights_gb": gbytes, "greedy": mix, "routed_per_layer": dec_routed,
        "decode_vs_prefill_rel_err": rel, "decode_ms_per_token_b1": ms,
        "decode_ms_per_token_b1_eager": ms_e,
        "decode_tokens_per_s_b1": 1e3 / ms, "device_busy_ms_per_token": busy,
        "kernel2_ms_per_token": k2, "other_ms_per_token": busy - k1 - k2,
        "other_launches_per_token": rest_n,
        "idle_share": 1 - busy / ms, "kernel1_ms_per_token": k1,
        "routed_floor_ms": floor_ms, "routed_floor_gb": floor_b / 1e9,
        "gated_vs_dense_rel_err": moe_rel, "argmax_parts": parts,
        "profile": prof, "serving16": serve,
        "seconds": time.perf_counter() - t0}
    log(f"[time] phase 13a: {time.perf_counter() - t0:.1f} s")
    del model, sparse_lg, dense_lg
    gc.collect()
    torch.cuda.empty_cache()

    # --- 13b Gemma-3-12B text
    t0 = time.perf_counter()
    model, gbytes, t_build = arch_model(GEMMA3, dev, seed=1)
    log(f"[gemma3] weights built in {t_build:.1f} s, {gbytes:.2f} GB")
    g1 = arch_greedy("gemma3", model, p1, ARCH_NEW, GEMMA3["vocab"])
    out["launches"]["gemma3_generate_greedy_b1"] = g1["launches"]
    rel_g = decode_vs_prefill("gemma3", model, p1, production_gate=False)
    ms_g, ms_ge = decode_rate_b1(model, p1, 32)
    prof_g = profile_decode(model, p1)
    busy_g = prof_g["device_ms_per_token"]
    k1_g = sum(t for n, t, _ in prof_g["kernels"] if "qmm_kernel" in n)
    log(f"[gemma3] decode batch 1: {1e3 / ms_g:.2f} tokens/s ({ms_g:.3f} ms "
        f"a token graphed, {ms_ge:.3f} eager); device busy {busy_g:.3f} ms "
        f"a token (idle share {1 - busy_g / ms_g:.1%}), "
        f"{prof_g['device_launches_per_token']:.0f} launches a token; kernel "
        f"1 {k1_g:.3f} ms a token")
    for name, t in prof_g["top"]:
        log(f"[gemma3] profile: {t:6.3f} ms/token  {name}")
    serve_g = arch_serving("gemma3", model, dev, GEMMA3["vocab"])
    out["launches"]["gemma3_serving16"] = serve_g["launches"]
    out["gemma3"] = {"weights_gb": gbytes, "greedy": g1,
                     "decode_vs_prefill_rel_err": rel_g,
                     "decode_ms_per_token_b1": ms_g,
                     "decode_ms_per_token_b1_eager": ms_ge,
                     "device_busy_ms_per_token": busy_g,
                     "kernel1_ms_per_token": k1_g, "profile": prof_g,
                     "serving16": serve_g,
                     "seconds": time.perf_counter() - t0}
    log(f"[time] phase 13b: {time.perf_counter() - t0:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # --- 13c Command R7B, GPT-2 and StarCoder layers at published width
    t0 = time.perf_counter()
    for tag, cfg, max_seq in (("cohere2", COHERE2, 2048),
                              ("gpt2", GPT2, 1024),
                              ("starcoder", STARCODER, 2048)):
        model, gbytes, _ = arch_model(cfg, dev, seed=2, max_seq=max_seq)
        st = model.static
        if tag == "cohere2":
            assert st.parallel_blocks and not st.layers[3].rope_enabled
        elif tag == "starcoder":
            assert (st.num_heads, st.num_kv_heads) == (48, 1)
        else:
            assert st.learned_pos_emb and model.weights.pos_emb is not None
        g = arch_greedy(tag, model, p1 % cfg["vocab"], ARCH_NEW,
                        cfg["vocab"])
        out["launches"][f"{tag}_generate_greedy_b1"] = g["launches"]
        out[tag] = {"weights_gb": gbytes, "greedy": g,
                    "decode_vs_prefill_rel_err": decode_vs_prefill(
                        tag, model, p1 % cfg["vocab"],
                        witness=tag == "starcoder")}
        if tag == "starcoder":
            # kernels 2 and 3 held on the path's own inputs at 48 query
            # heads a KV head, and kernel 3 on the serving path
            out[tag]["held"] = starcoder_held(model, dev,
                                              p1 % cfg["vocab"])
            out[tag]["serving16"] = arch_serving(tag, model, dev,
                                                 cfg["vocab"])
            out["launches"]["starcoder_serving16"] = \
                out[tag]["serving16"]["launches"]
        del model
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[time] phase 13c: {time.perf_counter() - t0:.1f} s")
    out["seconds"] = time.perf_counter() - t_all
    out["gated_launches_b1"] = mix["b1"]["launches"]["qmm_gated"]
    return out


# --------------------------------------------------------------- phase 14

# Qwen/Qwen2.5-VL-7B-Instruct: config.json and preprocessor_config.json as
# published (full width and depth)
QWEN25VL = {
    "architectures": ["Qwen2_5_VLForConditionalGeneration"],
    "hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4,
    "vocab_size": 152064, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
    "max_position_embeddings": 128000, "tie_word_embeddings": False,
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vision_config": {
        "depth": 32, "hidden_size": 1280, "intermediate_size": 3420,
        "num_heads": 16, "out_hidden_size": 3584, "patch_size": 14,
        "spatial_merge_size": 2, "spatial_patch_size": 14,
        "temporal_patch_size": 2, "window_size": 112,
        "fullatt_block_indexes": [7, 15, 23, 31], "hidden_act": "silu",
        "in_chans": 3}}
CLIP_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_STD = [0.26862954, 0.26130258, 0.27577711]
QWEN25VL_PREP = {"image_processor_type": "Qwen2VLImageProcessor",
                 "min_pixels": 3136, "max_pixels": 12845056, "patch_size": 14,
                 "temporal_patch_size": 2, "merge_size": 2,
                 "image_mean": CLIP_MEAN, "image_std": CLIP_STD,
                 "rescale_factor": 1 / 255}
# its language model for random_model_weights: Qwen2's q/k/v biases
QWEN25VL_LM = dict(vocab=152064, hidden=3584, layers=28, heads=28, kv_heads=4,
                   inter=18944, rope_theta=1e6, attn_bias=True)
# google/gemma-3-12b-it: the SigLIP tower as published, the text model at 4
# of its 48 layers (phase 13's geometry)
GEMMA3_VLM = {
    "architectures": ["Gemma3ForConditionalGeneration"],
    "mm_tokens_per_image": 256,
    "text_config": {"hidden_size": 3840, "intermediate_size": 15360,
                    "num_hidden_layers": 4, "num_attention_heads": 16,
                    "num_key_value_heads": 8, "head_dim": 256,
                    "vocab_size": 262208, "sliding_window": 1024,
                    "rope_theta": 1e6},
    "vision_config": {"model_type": "siglip_vision_model",
                      "hidden_size": 1152, "image_size": 896,
                      "intermediate_size": 4304, "num_attention_heads": 16,
                      "num_hidden_layers": 27, "patch_size": 14,
                      "hidden_act": "gelu_pytorch_tanh"}}
GEMMA3_PREP = {"image_processor_type": "Gemma3ImageProcessor",
               "size": {"height": 896, "width": 896},
               "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5],
               "rescale_factor": 1 / 255, "resample": 2}
# mistralai/Mistral-Small-3.1-24B-Instruct-2503: the pixtral tower and its
# patch merger as published, the text model at 2 of its 40 layers
MISTRAL3 = {
    "architectures": ["Mistral3ForConditionalGeneration"],
    "spatial_merge_size": 2, "multimodal_projector_bias": False,
    "text_config": {"hidden_size": 5120, "intermediate_size": 32768,
                    "num_hidden_layers": 2, "num_attention_heads": 32,
                    "num_key_value_heads": 8, "head_dim": 128,
                    "vocab_size": 131072, "rope_theta": 1e9},
    "vision_config": {"model_type": "pixtral", "hidden_size": 1024,
                      "head_dim": 64, "num_attention_heads": 16,
                      "num_hidden_layers": 24, "intermediate_size": 4096,
                      "patch_size": 14, "image_size": 1540,
                      "rope_theta": 10000.0, "hidden_act": "silu"}}
MISTRAL3_PREP = {"image_processor_type": "PixtralImageProcessor",
                 "patch_size": {"height": 14, "width": 14},
                 "size": {"longest_edge": 1540}, "image_mean": CLIP_MEAN,
                 "image_std": CLIP_STD, "rescale_factor": 1 / 255,
                 "resample": 3}
MISTRAL3_LM = dict(vocab=131072, hidden=5120, layers=2, heads=32, kv_heads=8,
                   head_dim=128, inter=32768, rope_theta=1e9)
VLM_IMAGE = (1024, 768)         # (w, h) of the seeded images
VLM_JOBS, VLM_TEXT_JOBS, VLM_TEXT, VLM_NEW = 8, 4, 32, 48
VLM_PAGES = 48                  # 8 x 5 pages of image jobs, 4 text pages
VLM_TOL = 0.02                  # the tower cut's gate, of max |CPU|
VLM_B1_NEW = 32


def vlm_config(tag: str, config: dict, prep: dict):
    """A ModelConfig read from `config` and `prep`, written as config.json
    and preprocessor_config.json to build/vlm_<tag>/ (no weights)."""
    from exllamav2_tpu_torch.config import ModelConfig
    d = os.path.join(OUT_DIR, f"vlm_{tag}")
    os.makedirs(d, exist_ok=True)
    for name, obj in (("config.json", config),
                      ("preprocessor_config.json", prep)):
        with open(os.path.join(d, name), "w") as f:
            json.dump(obj, f)
    cfg = ModelConfig(model_dir=d)
    cfg.load_dict(config)
    return cfg


def vlm_image(rng, size=VLM_IMAGE):
    return (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)


def tower_ms(tower, px, thw, iters: int = 3) -> float:
    """Device ms of one tower pass (process: patch embedding, blocks,
    projector), CUDA events around `iters` passes after a warm one."""
    return eager_ms(lambda: tower.process(px, None, thw), iters)


@contextlib.contextmanager
def held_kernels(tag):
    """While on, every call of kernel 3's wrapper (P.paged_decode_attention)
    and kernel 1's (Q.fused_segment_matmul) launches its kernel as before,
    and the first call at each shape is also held against the plain version
    on the same inputs: max |kernel - plain| <= QMM_TOL of max |plain|
    (kernel 1, as phase 2 holds it; its gated entry at each shape with the
    flag set and with it clear, where it must write zeros) or
    ATTN_PATH_TOL of max |v| in the layer's pool (kernel 3), or the phase
    fails. Yields {"paged": {(b, hq, hkv, pages): rel}, "paged_f64": {(b,
    hq, hkv, pages): [kernel, plain] against the f64 evaluation}, "qmm":
    {(m, k, n): rel, (m, k, n, "gated" or "gated off"): rel}, "seconds": s},
    filled as the calls come (seconds: the plain versions' wall time,
    synchronized, for the caller to take out of its own). Eager steps only:
    a graph capture reads nothing back."""
    from exllamav2_tpu_torch.cache_paged import _raw
    from exllamav2_tpu_torch.ops import paged_attn as P
    from exllamav2_tpu_torch.ops import qmm as Q
    held = {"paged": {}, "qmm": {}, "paged_f64": {}, "seconds": 0.0}
    attn, mm = P.paged_decode_attention, Q.fused_segment_matmul

    def hold(kind, key, got, plain, scale, tol, also=None):
        if key not in held[kind]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref = plain()
            rel = ((got - ref).abs().max() / scale(ref)).item()
            held[kind][key] = rel
            if also:
                held[kind + "_f64"][key] = also(got, ref)
            held["seconds"] += time.perf_counter() - t
            if not (torch.isfinite(got).all() and rel <= tol):
                raise AssertionError(f"{tag}: {kind} at {key}: rel err "
                                     f"{rel:.3g} against its plain version")
        return got

    def attn_held(*a, **kw):
        # (q, k_data, v_data, layer, block_table, valid_lens, k_scales,
        #  v_scales, scale, page_size, hq, kinds, softcap, window)
        v, layer, vs = a[2], a[3], a[7]

        def vmax(_=None):
            return P._dq_page(_raw(v)[layer].view(v.dtype),
                              None if vs is None else vs[layer],
                              a[11][1]).abs().max()

        def f64(got, ref):
            # kernel and plain version against the same rounding points
            # evaluated in f64: each is a bf16 step of p away at most
            r64 = P.paged_decode_attention_plain(*a, dtype=torch.float64)
            vm = vmax()
            return [((x - r64).abs().max() / vm).item() for x in (got, ref)]
        return hold("paged", (a[0].shape[0], a[10], a[1].shape[1],
                              a[4].shape[1]), attn(*a, **kw),
                    lambda: P.paged_decode_attention_plain(*a), vmax,
                    ATTN_PATH_TOL, f64)

    def mm_held(x, seg, gate=None):
        if seg.act8:
            raise AssertionError(f"{tag}: held_kernels holds kernel 1 only")
        got = mm(x, seg, gate)
        key = (x.shape[0], x.shape[1], got.shape[1])
        if gate is None:
            return hold("qmm", key, got, lambda: Q.qmm_plain(x, seg),
                        lambda ref: ref.abs().max(), QMM_TOL)
        on = bool(gate.item())
        return hold("qmm", key + ("gated" if on else "gated off",), got,
                    lambda: Q.qmm_gated_plain(x, seg, gate),
                    lambda ref: ref.abs().max() if on else 1.0, QMM_TOL)

    P.paged_decode_attention, Q.fused_segment_matmul = attn_held, mm_held
    try:
        yield held
    finally:
        P.paged_decode_attention, Q.fused_segment_matmul = attn, mm


def check_held(tag, model, held, rows=(1, 16)) -> dict:
    """held_kernels' results must cover kernel 1 at every m of `rows` for
    every segment shape of the model's quantized linears (each layer's q, k,
    v, o, gate, up, down and the head) and kernel 3 at every batch of
    `rows` at the model's heads."""
    from exllamav2_tpu_torch.quant.qtensor import QuantLinear
    st, w = model.static, model.weights
    want = {(s.rows_pad, s.plane0.shape[1])
            for lw in w.layers
            for lin in (lw.attn.q, lw.attn.k, lw.attn.v, lw.attn.o,
                        lw.mlp.gate, lw.mlp.up, lw.mlp.down, w.head)
            if isinstance(lin, QuantLinear) for s in lin.segments}
    missing = [(m, k, n) for m in rows for k, n in sorted(want)
               if (m, k, n) not in held["qmm"]]
    heads = {(b, hq, hkv) for b, hq, hkv, _ in held["paged"]}
    missing += [(b, st.num_heads, st.num_kv_heads) for b in rows
                if (b, st.num_heads, st.num_kv_heads) not in heads]
    worst = {k: max(held[k].values(), default=float("nan"))
             for k in ("qmm", "paged")}
    log(f"[{tag}] kernels 1 and 3 on the path's own inputs against their "
        f"plain versions: kernel 1 at {len(held['qmm'])} shapes (m, k, n) "
        f"{sorted(held['qmm'])}, worst rel err {worst['qmm']:.2e}; kernel 3 "
        f"at {len(held['paged'])} (b, hq, hkv, pages) "
        f"{sorted(held['paged'])}, worst rel err {worst['paged']:.2e} "
        f"(limits {QMM_TOL} of max |plain| and {ATTN_PATH_TOL:.2e} of max "
        f"|v|); kernel 3 and its plain version against the same rounding "
        f"points in f64, of max |v|: " + ", ".join(
            f"{k} {a:.1e} / {b:.1e}"
            for k, (a, b) in sorted(held["paged_f64"].items())))
    if missing:
        raise AssertionError(f"{tag}: no held call at {missing}")
    return {"qmm": {str(k): v for k, v in held["qmm"].items()},
            "paged": {str(k): v for k, v in held["paged"].items()},
            "paged_f64": {str(k): v for k, v in held["paged_f64"].items()},
            "worst": worst}


def logged(gen):
    """Record `gen`'s prefill forwards (their id shapes) and decode step
    dispatches (their keys) from now on -> (shapes, keys), filled as it
    runs."""
    from exllamav2_tpu_torch.generator.dynamic import PREFILL_KEYS
    shapes, keys = [], []
    prefill, run = gen._prefill_forward, gen._run

    def prefill_logged(ids, *a, **kw):
        shapes.append(ids.shape)
        return prefill(ids, *a, **kw)

    def run_logged(key, *a):
        if key[0] not in PREFILL_KEYS:
            keys.append(key)
        return run(key, *a)

    gen._prefill_forward, gen._run = prefill_logged, run_logged
    return shapes, keys


def vlm_want(model, shapes, keys) -> dict:
    """The kernel launches of the logged prefill forwards (no head) and
    step dispatches (k one-token forwards a burst of k, head included)."""
    hd, layers = head_launches(model), model.static.num_layers
    want = {"qmm": sum(step_launches(model, b * t)["qmm"]
                       for b, t in shapes),
            "qmm_gated": 0, "decode_attn": 0, "paged_decode_attn": 0}
    for key in keys:
        k = key[3] if key[0] == "decode_burst" else 1
        want["qmm"] += k * (step_launches(model, key[1])["qmm"] + hd)
        want["paged_decode_attn"] += k * layers
    return want


def check_launches(tag, model, shapes, keys) -> dict:
    got, want = arch_counts(), vlm_want(model, shapes, keys)
    log(f"[{tag}] launches {got} (expected {want} from {len(shapes)} "
        f"prefill forwards and {len(keys)} step dispatches)")
    if got != want:
        raise AssertionError(f"{tag} launch counts {got} != {want}")
    return got


def mm_ids(rng, emb, text: int = VLM_TEXT) -> np.ndarray:
    """A prompt: half of `text` random text tokens, the embedding's ids,
    the other half."""
    t = rng.integers(3, 250, text).astype(np.int32)
    return np.concatenate([t[:text // 2], emb.get_ids_array().astype(
        np.int32), t[text // 2:]])


def mm_job(gen, ids, emb, new, **kw):
    """One greedy job with return_logits to its end -> (job, [new] logits
    of its decode steps)."""
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    job = gen.enqueue(DynamicJob(ids, max_new_tokens=new,
                                 settings=kw.pop("settings",
                                                 Settings.greedy()),
                                 embeddings=[emb], return_logits=True, **kw))
    got = []
    while job.status != "done":
        for r in gen.iterate():
            if r["job"] is job and r.get("logits") is not None:
                got.append(torch.from_numpy(r["logits"][0]))
    torch.cuda.synchronize()
    return job, got


def mm_teacher_forced(gen, job, f32_probs=False) -> torch.Tensor:
    """The logits a job's decode steps should give: one t > 1 paged forward
    over its prompt and generated tokens but the last, from its embedding
    rows and, on an MRoPE model, the rope rows of the whole sequence
    (gen_mrope_pos_ids), on a cache of its own -> [new, vocab] f32 on the
    CPU. f32_probs keeps the attention probabilities in f32 (the forward
    rounds them to bf16 where the one-token kernel does not)."""
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.models import forward as F
    from exllamav2_tpu_torch.ops import paged_attn as P
    from exllamav2_tpu_torch.ops.mrope import gen_mrope_pos_ids, mrope_rows
    from exllamav2_tpu_torch.ops.rope import rope_params
    dev = gen.device
    seq = job.sequence[:-1]
    t = len(seq)
    cfg, st = gen.model.config, gen.model.static
    rope = None
    if cfg.arch.mrope:
        pos, _ = gen_mrope_pos_ids(
            seq.astype(np.int64), cfg.vision_spatial_merge_size,
            [e.get_vision_token_range() for e in job.embeddings],
            [e.thw_grid for e in job.embeddings], t)
        inv, scale = rope_params(cfg)
        rope = tuple(torch.from_numpy(a)[None].to(dev) for a in
                     mrope_rows(pos, inv, cfg.mrope_section, scale))
    pages = -(-t // gen.page_size) + 1
    cache = PagedKVCache.alloc(st.num_layers, pages, st.num_kv_heads,
                               st.head_dim, "bf16", gen.page_size,
                               device=dev)
    bt = torch.arange(1, pages, dtype=torch.int32, device=dev)[None]
    served = P.gqa_values
    if f32_probs:
        P.gqa_values = lambda p, v: torch.einsum(
            "bkgts,bksd->btkgd", p.float(), v.float())
    try:
        with torch.no_grad():
            logits, _ = F.model_forward_paged(
                gen.model.weights, st,
                torch.zeros((1, t), dtype=torch.int32, device=dev), cache,
                bt, torch.zeros((1,), dtype=torch.int32, device=dev),
                input_embeds=gen._chunk_embeds(job, seq), rope_rows=rope)
    finally:
        P.gqa_values = served
    return logits[0, job.prompt_len - 1:].cpu()


def mm_decode_vs_prefill(tag, gen, job, logits, gate_served=True) -> dict:
    """A graphed job's decode logits against mm_teacher_forced, max |diff|
    / max |prefill|, as served and with f32 probabilities (the gate, and
    the served one too where gate_served)."""
    dec = torch.stack(logits)
    out = {}
    for name, f32 in (("served", False), ("f32_probabilities", True)):
        ref = mm_teacher_forced(gen, job, f32)
        if not torch.isfinite(ref).all() or ref.shape != dec.shape:
            raise AssertionError(f"{tag}: teacher-forced logits {ref.shape}")
        out[name] = ((dec - ref).abs().max() / ref.abs().max()).item()
    log(f"[{tag}] decode vs prefill logits rel err {out['served']:.2e} as "
        f"served, {out['f32_probabilities']:.2e} with the prefill's "
        f"probabilities in f32 ({len(logits)} steps)")
    if not (out["f32_probabilities"] < 0.02
            and (out["served"] < 0.02 or not gate_served)):
        raise AssertionError(f"{tag}: decode vs prefill {out}")
    return out


def vlm_round(gen, tower, imgs, texts, embs=None):
    """One round: every request arrives at t0; each image goes through the
    tower in turn (or, with `embs`, the rows of an earlier round are used
    again) and its job is enqueued with the image between the halves of its
    text; the text-only jobs follow; iterate to the end. So every job's
    first token comes after all the towers. -> (jobs, embeddings, new
    tokens, wall s, each image job's tower s with the host's
    preprocessing)."""
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jobs, used, towers = [], [], []
    for i, img in enumerate(imgs):
        if embs is None:
            t = time.perf_counter()
            e = tower.get_image_embeddings(gen.model, gen.tokenizer, img)
            torch.cuda.synchronize()
            towers.append(time.perf_counter() - t)
        else:
            e = embs[i]
        used.append(e)
        tx = texts[i]
        ids = np.concatenate([tx[:VLM_TEXT // 2],
                              e.get_ids_array().astype(np.int32),
                              tx[VLM_TEXT // 2:]])
        jobs.append(gen.enqueue(DynamicJob(
            ids, max_new_tokens=VLM_NEW, settings=Settings.greedy(),
            embeddings=[e])))
    for tx in texts[len(imgs):]:
        jobs.append(gen.enqueue(DynamicJob(tx, max_new_tokens=VLM_NEW,
                                           settings=Settings.greedy())))
    iterate_delivering(gen, jobs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for j in jobs:
        j.time_request = t0
        toks = j.sequence[j.prompt_len:]
        if (j.new_tokens != VLM_NEW or toks.min() < 0
                or toks.max() >= gen.model.static.vocab_size):
            raise AssertionError(f"vlm round job: {j.new_tokens} tokens, "
                                 f"{j.eos_reason}")
    return jobs, used, sum(j.new_tokens for j in jobs), dt, towers


def vlm_tower_cut(tower, px, thw) -> dict:
    """Blocks 6 (windowed) and 7 (full attention) of the tower with its
    merger, on the card against the same cut in f32 on the CPU (bf16
    operands either way): max |diff| / max |CPU| < VLM_TOL."""
    import copy
    from exllamav2_tpu_torch.vlm import VisionTower
    cfg = dataclasses.replace(tower.cfg, vision_num_layers=2,
                              vision_fullatt_block_indexes=[1])
    parts = dict(layers=[tower.layers[6], tower.layers[7]],
                 patch_conv=tower.patch_conv, ln_pre=tower.ln_pre,
                 pos_emb=tower.pos_emb,
                 mmp=dict(kind=tower.mmp_kind, act=tower.mmp_act,
                          norm_kind=tower.mmp_norm_kind, norm=tower.mmp_norm,
                          patch_merger=tower.mmp_patch_merger,
                          up=tower.mmp_up, down=tower.mmp_down,
                          proj=tower.mmp_proj))
    cut = VisionTower(cfg, parts=parts)
    got = cut.process(px, None, thw).cpu()
    t = time.perf_counter()
    ref = copy.deepcopy(cut).to("cpu").process(px, None, thw)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"[vlm] tower cut (blocks 6 windowed and 7 full, merger) on the "
        f"card against f32 on the CPU: rel err {rel:.2e} over {got.shape} "
        f"(CPU {time.perf_counter() - t:.1f} s)")
    if not (torch.isfinite(got).all() and rel < VLM_TOL):
        raise AssertionError(f"vlm tower cut rel err {rel}")
    return {"rel_err": rel, "rows": list(got.shape)}


def vlm_b1(gen, ids, emb, n: int) -> dict:
    """Batch-1 decode of an image job: a job for 1 + n new tokens less a
    job for 1, over n, both taking the prompt's full pages from the cache
    (a warm job fills them): wall ms a token, and under the profiler the
    device busy ms and kernel 1's ms a token."""
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings

    def run(n_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        job = gen.enqueue(DynamicJob(ids, max_new_tokens=n_new,
                                     settings=Settings.greedy(),
                                     embeddings=[emb]))
        while job.status != "done":
            gen.iterate()
        torch.cuda.synchronize()
        return None, job, time.perf_counter() - t

    run(1 + n)
    short = min(run(1)[2] for _ in range(2))
    long = min(run(1 + n)[2] for _ in range(2))
    per_s, busy_s, _ = profile_round(lambda: run(1))
    per_l, busy_l, _ = profile_round(lambda: run(1 + n))

    def k1(per):
        return sum(t for k, (t, _) in per.items() if "qmm_kernel" in k)

    reused = run(1)[1].reused_tokens
    return {"ms_per_token": (long - short) / n * 1e3,
            "device_busy_ms_per_token": (busy_l - busy_s) / n,
            "kernel1_ms_per_token": (k1(per_l) - k1(per_s)) / n,
            "reused_tokens": reused}


def vlm_qwen(dev, rate, rng) -> dict:
    """Phase 14a: Qwen2.5-VL-7B at full width and depth."""
    import gc
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.testing import random_vision_tower
    from exllamav2_tpu_torch.vlm import processing as VP
    out = {}
    t_all = time.perf_counter()
    cfg = vlm_config("qwen25vl", QWEN25VL, QWEN25VL_PREP)
    model, gbytes, t_build = arch_model(QWEN25VL_LM, dev, seed=3,
                                        max_seq=4096)
    model.config = cfg
    t = time.perf_counter()
    tower = random_vision_tower(cfg, seed=4, device=dev)
    torch.cuda.synchronize()
    log(f"[vlm] Qwen2.5-VL-7B: LM built in {t_build:.1f} s ({gbytes:.2f} "
        f"GB), tower in {time.perf_counter() - t:.1f} s")
    st = model.static
    tok = ByteTokenizer(256)        # no EOS id: every job runs all its tokens

    # 1. the tower: an image and a video
    img = vlm_image(rng)
    t = time.perf_counter()
    px, size, thw = VP.preprocess(cfg, img)
    prep_ms = (time.perf_counter() - t) * 1e3
    frames = [vlm_image(rng, (448, 448)) for _ in range(4)]
    vpx, _, vthw = VP.preprocess(cfg, frames)
    ms_img, ms_vid = tower_ms(tower, px, thw), tower_ms(tower, vpx, vthw)
    t = time.perf_counter()
    emb = tower.get_image_embeddings(model, tok, img)
    torch.cuda.synchronize()
    emb_ms = (time.perf_counter() - t) * 1e3
    vid = tower.get_video_embeddings(model, tok, frames)
    if (size != (1036, 756) or thw != (1, 54, 74)
            or tuple(emb.embeddings.shape) != (999, st.hidden_size)
            or vthw != (2, 32, 32) or vid.embeddings.shape[0] != 512
            or not torch.isfinite(emb.embeddings).all()):
        raise AssertionError(f"vlm: image {size} {thw} "
                             f"{tuple(emb.embeddings.shape)}, video {vthw}")
    log(f"[vlm] tower: {ms_img:.2f} ms an image (3996 patches -> 999 rows; "
        f"get_image_embeddings {emb_ms:.1f} ms with the host's resize), "
        f"{ms_vid:.2f} ms the 4-frame video (2048 patches -> 512 rows); "
        f"the host's preprocessing (resize, normalisation, patches) "
        f"{prep_ms:.1f} ms an image")
    out["tower"] = {"ms_image": ms_img, "ms_video": ms_vid,
                    "embedding_ms_image": emb_ms,
                    "preprocess_ms_image": prep_ms}

    # 2. two blocks and the merger against the CPU
    out["tower_cut"] = vlm_tower_cut(tower, px, thw)

    # 3. the serving round: 8 image jobs and 4 text jobs, graphed (a warm
    # round of other images, then the measured one) and once eager
    cache = PagedKVCache.alloc(st.num_layers, VLM_PAGES + 1, st.num_kv_heads,
                               st.head_dim, "bf16", device=dev)

    def new_gen(graphs):
        return DynamicGenerator(model, cache, tok, max_batch_size=16,
                                max_chunk_size=1024, decode_burst=16,
                                graphs=graphs)

    def requests():
        return ([vlm_image(rng) for _ in range(VLM_JOBS)],
                [rng.integers(3, 250, VLM_TEXT).astype(np.int32)
                 for _ in range(VLM_JOBS + VLM_TEXT_JOBS)])

    log(f"[time] phase 14a tower: {time.perf_counter() - t_all:.1f} s")
    gen = new_gen(True)
    vlm_round(gen, tower, *requests())                    # warm round
    log(f"[time] phase 14a warm round: {time.perf_counter() - t_all:.1f} s")
    imgs, texts = requests()
    zero_counts()
    g0 = graph_counts(gen)
    shapes, keys = logged(gen)
    with PrefillTimer(gen) as pt:
        jobs, embs, new, dt, towers = vlm_round(gen, tower, imgs, texts)
    got = check_launches("vlm qwen2.5-vl round", model, shapes, keys)
    g_round = graph_counts(gen, g0)
    # TTFT from the requests' arrival (every tower runs first), and each
    # image job's TTFT less the other jobs' towers (its own tower and the
    # language model's queue)
    ttft = [(j.time_first_token - j.time_request) * 1e3
            for j in jobs[:VLM_JOBS]]
    own = [t - (sum(towers) - tw) * 1e3 for t, tw in zip(ttft, towers)]
    p50 = sorted(ttft)[len(ttft) // 2]
    i50 = sorted(range(len(own)), key=own.__getitem__)[len(own) // 2]
    offsets = sorted({j.mrope_offset for j in jobs})
    # a round of new requests under the profiler (the same ones again
    # would take their prompts' pages from the cache)
    per, busy, dt_prof = profile_round(
        lambda: vlm_round(gen, tower, *requests()))
    idle = 1 - busy / (dt_prof * 1e3)
    # TTFT less every tower (the language model's queue, prefill and first
    # step), and the idle share of a round without towers: the measured
    # round's image rows again with new texts (no prompt page in common),
    # graphed here and eager below
    less = sorted(t - sum(towers) * 1e3 for t in ttft)[len(ttft) // 2]
    dlv_less = delivered_p50(jobs[:VLM_JOBS], "time_request") \
        - sum(towers) * 1e3
    _, busy_nt, dt_nt = profile_round(
        lambda: vlm_round(gen, None, imgs, requests()[1], embs))
    log(f"[time] phase 14a measured and profiled rounds: "
        f"{time.perf_counter() - t_all:.1f} s")
    g_all = graph_counts(gen, g0)
    no_captures("vlm qwen2.5-vl rounds", g_all)
    pkeys = prefill_keys("vlm", gen)
    del gen
    # the same round eager, kernels 1 and 3 held against their plain
    # versions on its inputs (m = 16 in its decode steps), then one eager
    # batch-1 image job for m = 1; the plain versions' time is taken out
    # of the eager round's
    ids = mm_ids(rng, emb)
    gen_e = new_gen(False)
    with held_kernels("vlm qwen2.5-vl") as held:
        jobs_e, _, new_e, dt_e, _ = vlm_round(gen_e, None, imgs, texts, embs)
        dt_e -= held["seconds"]
        gen_1 = DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, 8, st.num_kv_heads, st.head_dim, "bf16",
            device=dev), tok, max_batch_size=4, graphs=False)
        mm_job(gen_1, ids, emb, 2)
    out["held"] = check_held("vlm qwen2.5-vl", model, held)
    same_tokens("vlm qwen2.5-vl", jobs, jobs_e)
    del gen_e, gen_1
    # the same image rows and texts eager without the held kernels (TTFT:
    # no tower runs), then a round of new texts under the profiler
    gen_e = new_gen(False)
    with PrefillTimer(gen_e) as pt_e:
        jobs_c, _, _, _, _ = vlm_round(gen_e, None, imgs, texts, embs)
    same_tokens("vlm qwen2.5-vl eager", jobs, jobs_c)
    less_e = sorted((j.time_first_token - j.time_request) * 1e3
                    for j in jobs_c[:VLM_JOBS])[VLM_JOBS // 2]
    dlv_less_e = delivered_p50(jobs_c[:VLM_JOBS], "time_request")
    _, busy_nte, dt_nte = profile_round(
        lambda: vlm_round(gen_e, None, imgs, requests()[1], embs))
    del gen_e
    idle_nt = (1 - busy_nt / (dt_nt * 1e3), 1 - busy_nte / (dt_nte * 1e3))
    pre = prefill_line("vlm", pt.summary(), pt_e.summary(), (less, less_e),
                       idle_nt, (dlv_less, dlv_less_e))
    log(f"[vlm] p50 TTFT of the image jobs less every tower {less:.1f} ms "
        f"graphed, {less_e:.1f} eager; rounds without towers under the "
        f"profiler: idle share {idle_nt[0]:.1%} graphed ({busy_nt:.1f} of "
        f"{dt_nt * 1e3:.1f} ms), {idle_nt[1]:.1%} eager ({busy_nte:.1f} of "
        f"{dt_nte * 1e3:.1f} ms); step graphs of the measured and profiled "
        f"rounds {g_all}")
    log(f"[vlm] round of {VLM_JOBS} image jobs and {VLM_TEXT_JOBS} text "
        f"jobs: {new} tokens in {dt * 1e3:.1f} ms = {new / dt:.1f} "
        f"tokens/s (eager {new_e / dt_e:.1f}); p50 TTFT of the image jobs "
        f"from arrival {p50:.1f} ms, the {VLM_JOBS} towers "
        f"{sum(towers) * 1e3:.1f} ms of it ({sum(towers) * 1e3 / p50:.1%}); "
        f"p50 of TTFT less the other jobs' towers {own[i50]:.1f} ms, its own "
        f"tower {towers[i50] * 1e3:.1f} ms of it "
        f"({towers[i50] * 1e3 / own[i50]:.1%}); "
        f"host {dt * 1e3 / max(1, len(keys)):.2f}"
        f" ms a dispatch ({len(keys)} dispatches, towers and prefill "
        f"included); a round of new requests under the profiler: device "
        f"busy {busy:.1f} ms of {dt_prof * 1e3:.1f} (idle share "
        f"{idle:.1%}); step graphs "
        f"{g_round}, {len(offsets)} distinct MRoPE offsets {offsets}")
    no_captures("vlm qwen2.5-vl round", g_round)
    top = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    for name, (tt, c) in top:
        log(f"[vlm] round profile: {tt:8.2f} ms {c:6d}x  {name[:70]}")
    out["round"] = {"launches": got, "tokens_per_s": new / dt,
                    "tokens_per_s_eager": new_e / dt_e, "round_ms": dt * 1e3,
                    "p50_ttft_ms": p50, "towers_ms": sum(towers) * 1e3,
                    "towers_share_of_p50_ttft": sum(towers) * 1e3 / p50,
                    "p50_own_tower_ttft_ms": own[i50],
                    "own_tower_ms": towers[i50] * 1e3,
                    "own_tower_share": towers[i50] * 1e3 / own[i50],
                    "host_ms_per_dispatch": dt * 1e3 / max(1, len(keys)),
                    "device_busy_ms": busy, "idle_share": idle,
                    "p50_ttft_less_towers_ms": less,
                    "p50_ttft_less_towers_ms_eager": less_e,
                    "p50_delivered_less_towers_ms": dlv_less,
                    "p50_delivered_less_towers_ms_eager": dlv_less_e,
                    "idle_share_no_towers": idle_nt[0],
                    "idle_share_no_towers_eager": idle_nt[1],
                    "prefill": pre, "prefill_keys": pkeys,
                    "step_graphs": g_round, "offsets": offsets,
                    "top_kernels": [(k[:70], tt, c) for k, (tt, c) in top]}

    log(f"[time] phase 14a rounds: {time.perf_counter() - t_all:.1f} s")
    # 4-8 on one image job, a generator of its own
    gen = DynamicGenerator(model, PagedKVCache.alloc(
        st.num_layers, 12, st.num_kv_heads, st.head_dim, "bf16", device=dev),
        tok, max_batch_size=4, decode_burst=16, graphs=True)
    zero_counts()
    shapes, keys = logged(gen)
    job, logits = mm_job(gen, ids, emb, VLM_B1_NEW)
    out["launches_b1"] = check_launches("vlm qwen2.5-vl b1", model, shapes,
                                        keys)
    out["decode_vs_prefill"] = mm_decode_vs_prefill("vlm qwen2.5-vl", gen,
                                                    job, logits)
    # 5. the negative control: the same decode at offset 0
    prepare = gen._prepare_mrope

    def zero_offset(j):
        prepare(j)
        j.mrope_offset = 0

    gen._prepare_mrope = zero_offset
    ctrl_job, ctrl_logits = mm_job(gen, ids, emb, VLM_B1_NEW)
    del gen._prepare_mrope
    ctrl = torch.stack(ctrl_logits)
    ref = mm_teacher_forced(gen, ctrl_job)
    out["control_rel_err"] = ((ctrl - ref).abs().max()
                              / ref.abs().max()).item()
    log(f"[vlm] control: the same decode with the offsets forced to 0 "
        f"(job offset {job.mrope_offset}): rel err "
        f"{out['control_rel_err']:.2e} (must fail the 0.02 gate)")
    if not out["control_rel_err"] >= 0.02 and dev.type == "cuda":
        raise AssertionError("vlm: the zero-offset control passes the gate")
    log(f"[time] phase 14a decode vs prefill and control: "
        f"{time.perf_counter() - t_all:.1f} s")
    # 6. batch-1 decode rate, 8. prompt reuse
    b1 = vlm_b1(gen, ids, emb, VLM_B1_NEW)
    lw = model.weights.layers[0]
    lin_b = st.num_layers * sum(linear_bytes(x, 1) for x in (
        lw.attn.q, lw.attn.k, lw.attn.v, lw.attn.o, lw.mlp.gate, lw.mlp.up,
        lw.mlp.down)) + linear_bytes(model.weights.head, 1)
    b1["bound_ms"] = lin_b / rate * 1e3
    b1["bound_gb"] = lin_b / 1e9
    log(f"[vlm] batch-1 image job: {1e3 / b1['ms_per_token']:.2f} tokens/s "
        f"({b1['ms_per_token']:.3f} ms a token); device busy "
        f"{b1['device_busy_ms_per_token']:.3f} ms a token (idle share "
        f"{1 - b1['device_busy_ms_per_token'] / b1['ms_per_token']:.1%}); "
        f"kernel 1 {b1['kernel1_ms_per_token']:.3f} ms a token against the "
        f"linears' byte bound {b1['bound_ms']:.3f} ms "
        f"({b1['bound_gb']:.2f} GB); the prompt's pages reused: "
        f"{b1['reused_tokens'] // gen.page_size} "
        f"({b1['reused_tokens']} of {len(ids)} tokens)")
    if b1["reused_tokens"] < 3 * gen.page_size:
        raise AssertionError(f"vlm: reused {b1['reused_tokens']} tokens")
    out["b1"] = b1
    # 7. CFG at 1.0: the plain job's tokens up to a near-tie
    cfg_job, _ = mm_job(gen, ids, emb, VLM_B1_NEW,
                        settings=Settings.greedy(cfg_scale=1.0),
                        negative_prompt_ids=rng.integers(
                            3, 250, 24).astype(np.int32))
    pa, pb = job.sequence[job.prompt_len:], cfg_job.sequence[job.prompt_len:]
    diff = np.nonzero(pa != pb)[0]
    gap = None
    if diff.size:
        top = torch.topk(logits[int(diff[0])], 2).values
        gap = ((top[0] - top[1]) / logits[int(diff[0])].abs().max()).item()
        if not gap < TIE_GAP:
            raise AssertionError(f"vlm CFG 1.0 parts at {int(diff[0])} off "
                                 f"a near-tie ({gap:.2e})")
    log(f"[vlm] CFG at 1.0 on the image job: tokens equal the plain "
        f"job's: {not diff.size}"
        + (f" (parts at {int(diff[0])}, top-2 gap {gap:.2e})" if gap else ""))
    out["cfg_parts_at"] = None if not diff.size else int(diff[0])
    out["captures"] = graph_counts(gen)
    keys = {**gen.step_graphs.captures, **gen.prefill_graphs.captures}
    log(f"[vlm] the one-job generator: offsets {job.mrope_offset} and 0 "
        f"(the control) through {len(keys)} keys, each captured once: "
        f"{all(n == 1 for n in keys.values())}")
    if not all(n == 1 for n in keys.values()):
        raise AssertionError(f"vlm: a key captured again: {keys}")
    del gen, model, tower, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vlm_b1_leg(tag, dev, rng, config, prep, lm, gate_served) -> dict:
    """Phases 14b and 14c: a tower at full depth and width over a cut
    language model: the tower's ms, one image job at batch 1 graphed and
    once eager (bitwise the same tokens, launch counts asserted), and its
    decode against the prefill."""
    import gc
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.testing import random_vision_tower
    from exllamav2_tpu_torch.vlm import processing as VP
    t0 = time.perf_counter()
    cfg = vlm_config(tag, config, prep)
    model, gbytes, _ = arch_model(lm, dev, seed=5, max_seq=2048)
    model.config = cfg
    tower = random_vision_tower(cfg, seed=6, device=dev)
    tok = ByteTokenizer(256)
    img = vlm_image(rng)
    px, size, thw = VP.preprocess(cfg, img)
    ms = tower_ms(tower, px, thw)
    emb = tower.get_image_embeddings(model, tok, img)
    ids = mm_ids(rng, emb, 16)
    st = model.static
    log(f"[vlm] {tag}: tower {ms:.2f} ms an image ({size[0]}x{size[1]} px "
        f"-> {emb.embeddings.shape[0]} rows), LM {gbytes:.2f} GB")
    seqs = {}
    for graphs in (True, False):
        gen = DynamicGenerator(model, PagedKVCache.alloc(
            st.num_layers, 8, st.num_kv_heads, st.head_dim, "bf16",
            device=dev), tok, max_batch_size=4, decode_burst=16,
            graphs=graphs)
        zero_counts()
        shapes, keys = logged(gen)
        job, logits = mm_job(gen, ids, emb, VLM_B1_NEW)
        launches = check_launches(f"vlm {tag}", model, shapes, keys)
        seqs[graphs] = job.sequence.tolist()
        if graphs:
            rel = mm_decode_vs_prefill(f"vlm {tag}", gen, job, logits,
                                       gate_served)
        del gen
    log(f"[vlm] {tag}: graphed tokens equal the eager path's: "
        f"{seqs[True] == seqs[False]}")
    if seqs[True] != seqs[False]:
        raise AssertionError(f"vlm {tag}: graphed and eager tokens differ")
    del model, tower
    gc.collect()
    torch.cuda.empty_cache()
    return {"tower_ms": ms, "rows": emb.embeddings.shape[0],
            "launches": launches, "decode_vs_prefill": rel,
            "seconds": time.perf_counter() - t0}


def phase_vlm(dev, rate):
    """Phase 14: the vision-language path. (a) Qwen2.5-VL-7B at full width
    and depth; (b) Gemma-3-12B's SigLIP tower; (c) Mistral-Small-3.1's
    pixtral tower with its patch merger."""
    rng = np.random.default_rng(14)
    out = {"launches": {}}
    t0 = time.perf_counter()
    out["qwen25vl"] = vlm_qwen(dev, rate, rng)
    out["launches"]["vlm_qwen25vl_round"] = out["qwen25vl"]["round"][
        "launches"]
    out["launches"]["vlm_qwen25vl_b1"] = out["qwen25vl"]["launches_b1"]
    log(f"[time] phase 14a: {time.perf_counter() - t0:.1f} s")
    for tag, config, prep, lm, gate_served in (
            ("gemma3", GEMMA3_VLM, GEMMA3_PREP, dict(GEMMA3, layers=4),
             False),
            ("mistral3", MISTRAL3, MISTRAL3_PREP, MISTRAL3_LM, True)):
        t = time.perf_counter()
        out[tag] = vlm_b1_leg(tag, dev, rng, config, prep, lm, gate_served)
        out["launches"][f"vlm_{tag}_b1"] = out[tag]["launches"]
        log(f"[time] phase 14 {tag}: {time.perf_counter() - t:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------- phase 15

CONVERT_LAYERS = 8          # of Llama-2-7B's 32 (phase 15 cuts the depth)
G1_BITS = (2, 3, 4, 5, 6, 8)
G1_GROUPS = (32, 128)
# G1 against its plain version: codes equal, dq and err within this share
# of max |plain| (the kernel repeats the plain loop's operations in its
# order, each rounded on its own: the phase logs whether they are bitwise)
G1_TOL = 1e-6
# one Llama-2-7B layer's GPTQ groups at gs 32: q, k, v, o | gate, up | down
G1_LAYER = {(HIDDEN, HIDDEN): 4 * HIDDEN // 32,
            (HIDDEN, INTER): 2 * HIDDEN // 32, (INTER, HIDDEN): INTER // 32}
CONVERT_DEFAULTS = ["-b", "4.0", "-hb", "8", "-r", "16", "-l", "256",
                    "-gs", "32"]


def g1_hessian_factor(k: int, gen, dev) -> torch.Tensor:
    """U (hinv = U^T U) of the Hessian of 2,048 correlated activation rows
    of width k, prepared by the converter's own AdaptiveGPTQ (act order,
    damped Cholesky)."""
    from exllamav2_tpu_torch.convert.gptq import AdaptiveGPTQ
    base = torch.randn((2048, 64), generator=gen, device=dev)
    mix = torch.randn((64, k), generator=gen, device=dev)
    x = base @ mix + 0.1 * torch.randn((2048, k), generator=gen, device=dev)
    g = AdaptiveGPTQ(torch.zeros((k, 1), device=dev))
    g.add_batch(x)
    g.prepare()
    return g.hessian_inv


def g1_bytes(blk: int, n: int) -> int:
    """What G1 must move for one group: w in, q, dq and err out, U's
    block."""
    return blk * n * (4 + 2 + 4 + 4) + blk * blk * 4


def g1_check(dev, rate) -> dict:
    """Kernel G1 against its plain version at the Llama-2-7B shapes, every
    width of the grids, groups of 32 and 128 rows, on a real U; timed at 4
    bits (the kernel's work does not depend on the width)."""
    from exllamav2_tpu_torch.convert import gptq as G
    gen = torch.Generator(device=dev)
    gen.manual_seed(1515)
    hinv = {k: g1_hessian_factor(k, gen, dev) for k in (HIDDEN, INTER)}
    rows, worst, worst_abs, bitwise = [], 0.0, 0.0, True
    for k, n in SHAPES:
        w = 0.02 * torch.randn((k, n), generator=gen, device=dev)
        for gs in G1_GROUPS:
            a = (k // 2) // gs * gs
            for bits in G1_BITS:
                qz = G.AdaptiveQuantizer(bits=bits)
                scale = qz.find_params(w[a:a + gs])[0]
                args = (w, hinv[k], scale, qz.qzero, qz.maxq, a, gs)
                before = G.LAUNCHES["gptq"]
                q, dq, err = G.gptq_rows(*args)
                if G.LAUNCHES["gptq"] != before + 1:
                    raise AssertionError("G1 did not count its launch")
                pq, pdq, perr = G.gptq_rows_plain(*args)
                torch.cuda.synchronize()
                codes = int((q != pq).sum())
                rel = max(((dq - pdq).abs().max() / pdq.abs().max()).item(),
                          ((err - perr).abs().max()
                           / perr.abs().max()).item())
                worst_abs = max(worst_abs, (dq - pdq).abs().max().item(),
                                (err - perr).abs().max().item())
                same = bool(torch.equal(dq, pdq) and torch.equal(err, perr))
                bitwise &= same and codes == 0
                worst = max(worst, rel)
                finite = torch.isfinite(dq).all() and torch.isfinite(
                    err).all()
                if codes or not rel <= G1_TOL or not finite:
                    raise AssertionError(
                        f"G1 {k}x{n} gs {gs} {bits} bits: {codes} codes "
                        f"differ, dq/err rel err {rel:.3g}")
                if bits != 4:
                    continue
                ms = graph_ms([lambda: G.gptq_rows(*args)], 64)
                plain = eager_ms(lambda: G.gptq_rows_plain(*args), 3)
                rows.append({"k": k, "n": n, "gs": gs, "ms": ms,
                             "plain_ms": plain, "bytes": g1_bytes(gs, n),
                             "bound_ms": g1_bytes(gs, n) / rate * 1e3,
                             "bitwise": same})
                log(f"[convert] G1 {k}x{n} gs {gs}: kernel {ms * 1e3:.2f} us,"
                    f" plain {plain:.3f} ms, bound "
                    f"{rows[-1]['bound_ms'] * 1e3:.3f} us; bitwise {same}")
    log(f"[convert] G1 against its plain version at {len(SHAPES)} shapes x "
        f"{len(G1_GROUPS)} groups x {len(G1_BITS)} widths: codes equal, "
        f"worst dq/err rel err {worst:.2e} (limit {G1_TOL}), bitwise "
        f"{bitwise}")
    return {"rows": rows, "max_rel_err": worst, "max_abs_err": worst_abs,
            "bitwise": bitwise}


def write_convert_source(path: str, dev, seed: int = 15) -> int:
    """Random fp16 weights at Llama-2-7B geometry, CONVERT_LAYERS layers and
    the full head, drawn on the card from a seed and written one
    safetensors file a layer (Hugging Face layout, no tokenizer: the
    converter's byte tokenizer cuts the calibration rows). -> bytes."""
    from exllamav2_tpu_torch.stloader import write_safetensors
    os.makedirs(path, exist_ok=True)
    cfg = {"architectures": ["LlamaForCausalLM"], "hidden_size": HIDDEN,
           "intermediate_size": INTER, "num_hidden_layers": CONVERT_LAYERS,
           "num_attention_heads": HEADS, "num_key_value_heads": HEADS,
           "vocab_size": VOCAB, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
           "max_position_embeddings": 4096, "tie_word_embeddings": False,
           "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "float16"}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=dev)).half(
        ).cpu().numpy()

    ones = np.ones(HIDDEN, np.float16)
    total = 0
    files = {"embed": {"model.embed_tokens.weight": rnd(VOCAB, HIDDEN)},
             "head": {"lm_head.weight": rnd(VOCAB, HIDDEN),
                      "model.norm.weight": ones}}
    for l in range(CONVERT_LAYERS):
        p = f"model.layers.{l}."
        files[f"layer_{l:02d}"] = {
            p + "input_layernorm.weight": ones,
            p + "post_attention_layernorm.weight": ones,
            **{p + f"self_attn.{x}_proj.weight": rnd(HIDDEN, HIDDEN)
               for x in "qkvo"},
            p + "mlp.gate_proj.weight": rnd(INTER, HIDDEN),
            p + "mlp.up_proj.weight": rnd(INTER, HIDDEN),
            p + "mlp.down_proj.weight": rnd(HIDDEN, INTER)}
    for name, tensors in files.items():
        write_safetensors(os.path.join(path, f"model-{name}.safetensors"),
                          tensors)
        total += sum(t.nbytes for t in tensors.values())
    return total


@contextlib.contextmanager
def convert_parts():
    """While on, the seconds of the converter's parts summed by name: the
    GPTQ quantize, Hessian factorization and RTN sweeps of AdaptiveGPTQ
    (the device work, synchronized at their end), the host's EXL2 packing
    and dequantization (the reconstruction check) and file writes. Yields
    {name: seconds}, filled as the conversion runs."""
    from exllamav2_tpu_torch.convert import gptq as G
    from exllamav2_tpu_torch.convert import pipeline as CP
    parts = {}
    saved = []

    def clock(owner, attr, name, sync):
        fn = getattr(owner, attr)

        def timed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            return out
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    for owner, attr, name, sync in (
            (G.AdaptiveGPTQ, "quantize", "gptq_quantize", True),
            (G.AdaptiveGPTQ, "prepare", "gptq_prepare", True),
            (G.AdaptiveGPTQ, "quantize_rtn", "rtn_measure", True),
            (CP.F, "exl2_pack_quantized", "host_pack", False),
            (CP.F, "exl2_dequantize", "host_dequantize", False),
            (CP, "write_safetensors", "write_files", False)):
        clock(owner, attr, name, sync)
    try:
        yield parts
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


class Stamped:
    """A stdout that stamps each line the converter prints (its progress
    and [STATUS] lines) with perf_counter, echoing it to the real one."""

    def __init__(self, out):
        self.out, self.lines, self.buf = out, [], ""

    def write(self, s):
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
            self.out.write(f"[convert] {line}\n")
        return len(s)

    def flush(self):
        self.out.flush()


def convert_times(t0: float, lines, layers: int) -> dict:
    """Seconds by stage and by layer from the stamped progress lines."""
    def at(text):
        return next(t for t, line in lines if line.strip() == text)

    meas = [at(f"-- measured layer {i}/{layers}")
            for i in range(1, layers + 1)]
    quant = [at(f"-- quantized layer {i}/{layers}")
             for i in range(1, layers + 1)]
    opt = at("-- optimized bit allocation")
    head = next(t for t, line in lines if "quantized lm_head" in line)
    done = next(t for t, line in lines if "compiled ->" in line)
    m_layer = np.diff(meas).tolist()        # layers 2.. (1 holds the load)
    q_layer = [quant[0] - opt] + np.diff(quant).tolist()
    m_mean = float(np.mean(m_layer))
    return {"load_and_setup": meas[0] - t0 - m_mean,
            "measure_per_layer": [meas[0] - t0] + m_layer,
            "measure_mean": m_mean,
            "optimize": opt - meas[-1],
            "quantize_per_layer": q_layer,
            "quantize_mean": float(np.mean(q_layer)),
            "head": head - quant[-1], "compile": done - head,
            "total": done - t0}


def segment_launches(model, steps: int) -> dict:
    """Kernel-1 and kernel-2 launches of generate_greedy at batch 1 with a
    prompt of more than 32 tokens: one launch a segment of every quantized
    linear in each of the steps one-token steps, and the head's segments on
    the prefill's last token too."""
    from exllamav2_tpu_torch.quant.qtensor import QuantLinear
    w = model.weights
    segs = sum(len(lin.segments) for lw in w.layers
               for lin in (lw.attn.q, lw.attn.k, lw.attn.v, lw.attn.o,
                           lw.mlp.gate, lw.mlp.up, lw.mlp.down)
               if isinstance(lin, QuantLinear))
    head = len(w.head.segments) if isinstance(w.head, QuantLinear) else 0
    return {"qmm": head + (segs + head) * steps, "qmm_gated": 0,
            "decode_attn": model.static.num_layers * steps,
            "paged_decode_attn": 0}


def layer0_gptq_vs_rtn(src: str, out: str, dev) -> dict:
    """Every linear of the converted layer 0 against round-to-nearest at the
    option the optimizer chose for it, in GPTQ's row order, on the layer's
    captured inputs: GPTQ's output error must be the smaller
    (tests/test_convert.py:31's property at full width)."""
    from exllamav2_tpu_torch.config import ModelConfig
    from exllamav2_tpu_torch.convert import pipeline as CP
    from exllamav2_tpu_torch.convert.gptq import AdaptiveGPTQ
    from exllamav2_tpu_torch.convert.qparams import qparams_attn, qparams_mlp
    from exllamav2_tpu_torch.models.loader import load_model
    from exllamav2_tpu_torch.stloader import STFile
    from exllamav2_tpu_torch.tokenizer import load_tokenizer
    cfg = ModelConfig.from_dir(src)
    cfg.num_hidden_layers = 1
    with torch.no_grad():
        w, st = load_model(cfg, device=dev)
        rows = np.clip(CP.calibration_rows(load_tokenizer(src), 16, 256),
                       0, VOCAB - 1)
        hs = CP.embed_rows(w, st, rows)
        _, cap = CP._layer_forward_capture(w.layers[0], st, hs, w.sin[:256],
                                           w.cos[:256], 0)
        cap = {k: v.half() for k, v in cap.items()}
        with open(os.path.join(out, "job.json")) as f:
            strategy = json.load(f)["strategy"]
        opts = {"attn": qparams_attn(32), "mlp": qparams_mlp(32)}
        subs = CP._layer_subs(cfg, w.layers[0], 0)
        path = os.path.join(out, "quant", "layer_0.safetensors")
        recons = CP._load_layer_recons(path, subs)
        stf = STFile(path)
        res = {}
        for sub in subs:
            qp = opts[sub.kind][strategy[f"0.{sub.kind}"]]
            w_t = sub.lin.weight.float()
            invperm = torch.from_numpy(stf.get_tensor(
                f"{sub.name}.q_invperm").astype(np.int64)).to(dev)
            g = AdaptiveGPTQ(w_t)
            g.w = w_t[torch.argsort(invperm)]
            rtn = g.quantize_rtn(qp.groups(w_t.shape[0]))[invperm]
            e_gptq = CP._sublayer_out_err(
                cap[sub.cap], w_t, torch.from_numpy(recons[sub.name]).to(dev))
            e_rtn = CP._sublayer_out_err(cap[sub.cap], w_t, rtn)
            res[sub.name.rsplit(".", 1)[1]] = {
                "option": qp.desc, "gptq": e_gptq, "rtn": e_rtn}
        stf.close()
    log("[convert] layer 0, output error on its captured inputs, GPTQ / RTN "
        "at the chosen option: " + ", ".join(
            f"{k} ({v['option']}) {v['gptq']:.3e} / {v['rtn']:.3e}"
            for k, v in res.items()))
    bad = [k for k, v in res.items() if not v["gptq"] < v["rtn"]]
    if bad:
        raise AssertionError(f"GPTQ no better than RTN on layer 0's {bad}")
    return res


def convert_bits(out: str, layers: int) -> dict:
    """The achieved bits per weight, exact from QParams.total_bits, of the
    strategy the converter chose (layers at Llama-2-7B width)."""
    from exllamav2_tpu_torch.convert.qparams import qparams_attn, qparams_mlp
    with open(os.path.join(out, "job.json")) as f:
        strategy = json.load(f)["strategy"]
    shapes = {"attn": [(HIDDEN, HIDDEN)] * 4,
              "mlp": [(HIDDEN, INTER)] * 2 + [(INTER, HIDDEN)]}
    opts = {"attn": qparams_attn(32), "mlp": qparams_mlp(32)}
    bits = weights = groups = 0
    choice = {}
    for l in range(layers):
        for kind in ("attn", "mlp"):
            qp = opts[kind][strategy[f"{l}.{kind}"]]
            choice[f"{l}.{kind}"] = qp.desc
            for k, n in shapes[kind]:
                bits += qp.total_bits(k, n)
                weights += k * n
                groups += len(qp.groups(k))
    return {"bpw": bits / weights, "groups": groups, "choice": choice}


def phase_convert(dev, rate):
    """Phase 15: G1 held to its plain version; a Llama-2-7B-width source
    (CONVERT_LAYERS layers) converted through `python -m
    exllamav2_tpu_torch.convert`'s entry with its defaults and served; the
    trained fixture converted on the card."""
    import io
    import shutil
    from exllamav2_tpu_torch.convert import __main__ as cli
    from exllamav2_tpu_torch.convert import gptq as G
    from exllamav2_tpu_torch.convert.pipeline import calibration_rows
    from exllamav2_tpu_torch.convert.qparams import qparams_head_for
    from exllamav2_tpu_torch.evals import perplexity
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    t_phase = time.perf_counter()
    out = {"g1": g1_check(dev, rate)}

    # (b) the full-width conversion
    src = os.path.join(OUT_DIR, "convert_src")
    dst = os.path.join(OUT_DIR, "convert_out")
    tt_out = os.path.join(OUT_DIR, "convert_trained_tiny")
    for d in (src, dst, tt_out):
        if os.path.isdir(d):
            shutil.rmtree(d)
    t = time.perf_counter()
    out["source_bytes"] = write_convert_source(src, dev)
    out["source_seconds"] = time.perf_counter() - t
    log(f"[convert] source: {CONVERT_LAYERS} of 32 Llama-2-7B layers and "
        f"the 32000x4096 head, {out['source_bytes'] / 1e9:.2f} GB fp16, "
        f"written in {out['source_seconds']:.1f} s")
    G.LAUNCHES["gptq"] = 0
    stamped = Stamped(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stamped), convert_parts() as parts:
        cli.main(["-i", src, "-o", dst, *CONVERT_DEFAULTS,
                  "--status_output", "--device", dev.type])
    torch.cuda.synchronize()
    launches = G.LAUNCHES["gptq"]
    times = convert_times(t0, stamped.lines, CONVERT_LAYERS)
    bits = convert_bits(dst, CONVERT_LAYERS)
    head_groups = len(qparams_head_for(8).groups(HIDDEN))
    want = bits["groups"] + head_groups
    out.update(times=times, bits=bits, g1_launches=launches,
               groups=want, parts=parts)
    scale = (32 * (out["source_bytes"] - 2 * VOCAB * HIDDEN * 2)
             / CONVERT_LAYERS + 2 * VOCAB * HIDDEN * 2) / out["source_bytes"]
    full = ((times["load_and_setup"] + times["compile"]) * scale
            + 32 * (times["measure_mean"] + times["quantize_mean"])
            + times["optimize"] + times["head"])
    out["full_depth_estimate_s"] = full
    log(f"[convert] {CONVERT_LAYERS} layers converted in "
        f"{times['total']:.1f} s: load and setup "
        f"{times['load_and_setup']:.1f}, measure "
        f"{times['measure_mean']:.2f} s a layer "
        f"({', '.join(f'{x:.2f}' for x in times['measure_per_layer'])}; "
        f"the first holds the load), optimize {times['optimize']:.2f}, "
        f"quantize {times['quantize_mean']:.2f} s a layer "
        f"({', '.join(f'{x:.2f}' for x in times['quantize_per_layer'])}), "
        f"head {times['head']:.2f}, compile {times['compile']:.1f}; full "
        f"depth (32 layers) estimate {full:.0f} s: 32 x (measure + "
        f"quantize a layer) + optimize + head + (setup + compile) x "
        f"{scale:.2f} (the source's bytes)")
    log("[convert] seconds by part, summed over the conversion: "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    log(f"[convert] bits per weight {bits['bpw']:.4f} (budget 4.0, exact "
        f"from total_bits); strategy {bits['choice']}; G1 launches "
        f"{launches} = groups quantized {want} ({bits['groups']} in the "
        f"layers, {head_groups} in the head); every linear passed the "
        f"reconstruction check (< 0.05)")
    if bits["bpw"] > 4.0:
        raise AssertionError(f"bpw {bits['bpw']} over the 4.0 budget")
    if launches != want:
        raise AssertionError(f"G1 launches {launches} != groups {want}")
    out["layer0"] = layer0_gptq_vs_rtn(src, dst, dev)

    # (c) serve the converted model
    model = Model.from_dir(dst, device=dev)
    segs = sorted({(s.bits, s.rows) for lw in model.weights.layers
                   for lin in (lw.attn.q, lw.attn.k, lw.attn.v, lw.attn.o,
                               lw.mlp.gate, lw.mlp.up, lw.mlp.down)
                   for s in lin.segments})
    log(f"[convert] served: {len(segs)} (bits, rows) segment kinds "
        f"{segs}")
    rng = np.random.default_rng(15)
    prompt = rng.integers(3, 250, (1, 48)).astype(np.int32)
    new = 32
    model.generate_greedy(prompt[:, :4], 2)               # warm-up
    torch.cuda.synchronize()
    zero_counts()
    seq = model.generate_greedy(prompt, new)
    torch.cuda.synchronize()
    got = arch_counts()
    want_l = segment_launches(model, new - 1)
    log(f"[convert] generate_greedy b1 graphed: launches {got} (expected "
        f"{want_l})")
    if got != want_l:
        raise AssertionError(f"converted model launches {got} != {want_l}")
    with held_kernels("convert") as held:
        seq_e = eager(model, lambda: model.generate_greedy(prompt, new))
        eager(model, lambda: model.generate_greedy(
            rng.integers(3, 250, (16, 40)).astype(np.int32), 3))
    if not np.array_equal(seq, seq_e):
        raise AssertionError(f"converted model: graphed {seq.tolist()} != "
                             f"eager {seq_e.tolist()}")
    want_keys = {(m, s.rows_pad, s.plane0.shape[1]) for m in (1, 16)
                 for lw in model.weights.layers
                 for lin in (lw.attn.q, lw.attn.k, lw.attn.v, lw.attn.o,
                             lw.mlp.gate, lw.mlp.up, lw.mlp.down,
                             model.weights.head) for s in lin.segments}
    missing = sorted(want_keys - set(held["qmm"]))
    worst = max(held["qmm"].values())
    log(f"[convert] graphed tokens equal the eager path's; kernel 1 held on "
        f"the converted linears at {len(held['qmm'])} (m, k, n) shapes, "
        f"worst rel err {worst:.2e} (limit {QMM_TOL})")
    if missing:
        raise AssertionError(f"convert: no held kernel-1 call at {missing}")
    out["serve"] = {"tokens": seq[:, 48:].tolist(), "launches": got,
                    "held_qmm": {str(k): v for k, v in held["qmm"].items()},
                    "decode_vs_prefill": decode_vs_prefill(
                        "convert", model, prompt[:, :24])}
    del model
    torch.cuda.empty_cache()

    # (d) the trained fixture, converted on the card
    tt = os.path.join(HERE, "tests", "fixtures", "trained_tiny")
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["-i", tt, "-o", tt_out, "-b", "4.0", "-hb", "6",
                  "--device", dev.type])
    tt_s = time.perf_counter() - t
    rows = calibration_rows(ByteTokenizer(), 16, 256, noise_rows=0)
    dense = Model.from_dir(tt, device=dev)
    conv = Model.from_dir(tt_out, device=dev)
    conv_cpu = Model.from_dir(tt_out, device="cpu")
    ppl = {"dense": perplexity(dense, rows), "converted": perplexity(
        conv, rows), "converted_q4_cache": perplexity(conv, rows, "q4")}
    p = np.array([[1, 50, 99, 7, 23]], np.int32)
    g_tok, c_tok = conv.generate_greedy(p, 16), conv_cpu.generate_greedy(p, 16)
    log(f"[convert] trained_tiny converted on the card in {tt_s:.1f} s; "
        f"perplexity on 16 x 256 corpus rows: dense {ppl['dense']:.4f}, "
        f"converted {ppl['converted']:.4f} (q4 cache "
        f"{ppl['converted_q4_cache']:.4f}); greedy tokens card "
        f"{g_tok[0, 5:].tolist()}, CPU {c_tok[0, 5:].tolist()}")
    if not np.array_equal(g_tok, c_tok):
        raise AssertionError("converted trained_tiny: card and CPU tokens "
                             "differ")
    if not all(np.isfinite(v) for v in ppl.values()):
        raise AssertionError(f"perplexity {ppl}")
    out["trained_tiny"] = {"seconds": tt_s, "perplexity": ppl,
                           "tokens": g_tok.tolist()}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] phase 15: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 16

SERVER_REQUESTS = 8     # concurrent infer requests of the round
SERVER_PROMPT = 128     # bytes (tokens) a prompt
SERVER_NEW = 64         # greedy new tokens a request
SERVER_LEN = 2048       # model_init -l
SERVER_STOP_AFTER = 8   # new tokens of the extra request before its stop
SERVER_GREEDY = {"top_k": 1, "temperature": 1.0, "top_p": 0.0,
                 "rep_pen": 1.0}
FPX_FORMATS = ((4, 3), (3, 2), (2, 1))      # e4m3, e3m2, e2m1: 8, 6, 4 bits
RR_TOL = 1e-3           # rank fraction 1.0 against the weight, of max |w|
KLD_SELF = 1e-6         # estimate_kld with A against A
SERVER_BATCH = 16       # the generator's max_batch_size: every request live
GIB = 1024 ** 3


def id_tokenizer():
    """The byte tokenizer with a decode that names every id ("<id>"): the
    converted model's directory has no tokenizer, and the byte tokenizer's
    decode drops ids past 255, which a random model draws 99 % of the time,
    so its streams would carry almost no text."""
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        def decode(self, ids) -> str:
            return "".join(f"<{int(i)}>" for i in np.asarray(ids).reshape(-1))

    return IdTokenizer()


def tokens_of(text: str) -> list:
    """The ids of an IdTokenizer text."""
    return [int(t) for t in text[1:-1].split("><")] if text else []


class Conn:
    """An in-process connection of the server: every message sent to it,
    decoded, beside the perf_counter time it arrived."""

    def __init__(self):
        self.sent = []

    async def send(self, message: str):
        self.sent.append((time.perf_counter(), json.loads(message)))


def server_prompts(rng) -> list:
    """SERVER_REQUESTS + 1 distinct prompts of SERVER_PROMPT letters (the
    last one the extra request's)."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    return [bytes(rng.choice(letters, SERVER_PROMPT)).decode()
            for _ in range(SERVER_REQUESTS + 1)]


def server_round(server, prompts, stop_extra: bool) -> dict:
    """One round of the websocket server's dispatch: SERVER_REQUESTS greedy
    infer requests, each on its own connection, all in flight together;
    echo, estimate_token and lefttrim_token on another connection meanwhile;
    with stop_extra, one more request that a stop ends once its job has
    SERVER_STOP_AFTER new tokens. Gates: each request's chunks joined equal
    its full text, the side actions answer as the tokenizer says, the
    stopped request ends with a full response and its job is cancelled."""
    import asyncio
    gen, tok = server.generator, server.tokenizer
    conns = [Conn() for _ in prompts]
    side = Conn()

    def infer(i, p):
        return {"action": "infer", "text": p, "max_new_tokens": SERVER_NEW,
                "request_id": i, **SERVER_GREEDY}

    extra_ids = tok.encode(prompts[-1])

    async def run():
        t0 = time.perf_counter()
        tasks = [asyncio.create_task(server.dispatch(infer(i, p), c))
                 for i, (p, c) in enumerate(zip(prompts[:-1], conns))]
        if stop_extra:
            tasks.append(asyncio.create_task(server.dispatch(
                infer("extra", prompts[-1]), conns[-1])))
        await server.dispatch({"action": "echo", "request_id": "e"}, side)
        await server.dispatch({"action": "estimate_token",
                               "text": prompts[0]}, side)
        await server.dispatch({"action": "lefttrim_token",
                               "text": prompts[1], "max_tokens": 16}, side)
        stopped = None
        while stop_extra and stopped is None:
            stopped = next((j for j in list(gen.active)
                            if np.array_equal(j.prompt_ids, extra_ids)
                            and j.new_tokens >= SERVER_STOP_AFTER), None)
            if any(m.get("response_type") == "full"
                   for _, m in conns[-1].sent):
                raise AssertionError("server: the extra request ended "
                                     "before its stop")
            await asyncio.sleep(0.0005)
        if stop_extra:
            await server.dispatch({"action": "stop", "request_id": "extra"},
                                  conns[-1])
        await asyncio.gather(*tasks)
        return t0, time.perf_counter(), stopped

    t0, t1, stopped = asyncio.run(run())
    out = {"seconds": t1 - t0, "texts": [], "first_chunk_ms": []}
    for i, c in enumerate(conns[:SERVER_REQUESTS]):
        chunks = [m["chunk"] for _, m in c.sent
                  if m.get("response_type") == "chunk"]
        full = [m for _, m in c.sent if m.get("response_type") == "full"]
        if len(full) != 1 or full[0].get("request_id") != i:
            raise AssertionError(f"server: request {i} got {full}")
        if "".join(chunks) != full[0]["response"]:
            raise AssertionError(f"server: request {i}'s chunks do not join "
                                 f"to its full text")
        out["texts"].append(full[0]["response"])
        out["first_chunk_ms"].append(
            (c.sent[0][0] - t0) * 1e3 if chunks else float("nan"))
    want = [{"action": "echo", "request_id": "e"},
            {"action": "estimate_token",
             "num_tokens": len(tok.encode(prompts[0]))},
            {"action": "lefttrim_token",
             "trimmed_text": tok.decode(tok.encode(prompts[1])[-16:])}]
    if [m for _, m in side.sent] != want:
        raise AssertionError(f"server: side actions {side.sent}")
    if stop_extra:
        extra = [m for _, m in conns[-1].sent]
        if extra[-1].get("response_type") != "full" or \
                {"action": "stop", "request_id": "extra"} not in extra:
            raise AssertionError(f"server: the stopped request {extra[-3:]}")
        if stopped.eos_reason != "cancelled" or stopped.pages:
            raise AssertionError(f"server: the stopped job {stopped.status} "
                                 f"{stopped.eos_reason}, {len(stopped.pages)}"
                                 f" pages held")
        out["stopped_at"] = stopped.new_tokens
        out["stopped_text_tokens"] = len(tokens_of(extra[-1]["response"]))
    out["tokens"] = sum(len(tokens_of(t)) for t in out["texts"])
    return out


def alone_check(tag, model, tok, prompts, texts, alone, gaps) -> list:
    """Each request's text against its prompt run alone: equal, or the first
    differing token falls on a near-tie of the alone run's teacher-forced
    logits (top-2 gap under TIE_GAP of max |logit|), else the phase fails.
    `gaps` keeps the gap of each (request, position) for the next call.
    -> the first differing position of each request (None where equal)."""
    out = []
    for i, (p, got, want) in enumerate(zip(prompts, texts, alone)):
        a, b = tokens_of(want), tokens_of(got)
        if a == b:
            out.append(None)
            continue
        d = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if (i, d) not in gaps:
            lg = teacher_forced_logits(model, tok.encode(p), a[:d + 1])[d]
            top = torch.topk(lg.float(), 2).values
            gaps[i, d] = ((top[0] - top[1]) / lg.abs().max()).item()
        gap = gaps[i, d]
        log(f"[cli] {tag}: request {i} parts from its prompt alone at new "
            f"token {d}: top-2 gap {gap:.2e} of max |logit| (limit "
            f"{TIE_GAP})")
        if not gap < TIE_GAP:
            raise AssertionError(f"{tag}: request {i} differs from its "
                                 f"prompt alone off a near-tie")
        out.append((d, gap))
    return out


def quiet(fn, *a):
    """fn(*a) with its standard output captured -> (result, the lines)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = fn(*a)
    return r, [l for l in buf.getvalue().replace("\r", "\n").splitlines()
               if l.strip()]


def phase_cli(dev, card):
    """Phase 16: phase 15's converted 8-layer Llama-2-7B-width model served
    through the tools around the model: model_init and fit_hbm, the
    websocket server's dispatch, the test_inference, estimate_kld and
    model_diff CLIs, fpxify of the fp16 source and rank reduction of its
    layer-0 MLP."""
    import argparse
    import gc
    from exllamav2_tpu_torch import model_init
    from exllamav2_tpu_torch.cli import (estimate_kld, fit_hbm, model_diff,
                                         test_inference)
    from exllamav2_tpu_torch.experimental.fpx import fpxify
    from exllamav2_tpu_torch.generator.dynamic import (DynamicGenerator,
                                                       _bucket)
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.quant.qtensor import pack_planes_on
    from exllamav2_tpu_torch.server.websocket import WebSocketServer
    from exllamav2_tpu_torch.tokenizer import ByteTokenizer
    from exllamav2_tpu_torch.utils.rank_reduce import rank_reduce_linear
    t_phase = time.perf_counter()
    src = os.path.join(OUT_DIR, "convert_src")
    dst = os.path.join(OUT_DIR, "convert_out")
    for d in (src, dst):
        if not os.path.isfile(os.path.join(d, "config.json")):
            raise AssertionError(f"cli: phase 15 left no model in {d}")
    out = {"card": card}
    seconds = {}

    # (a) model_init, beside fit_hbm's prediction; the loader packs plane
    # words on the card: the CPU's words (the tests hold those against the
    # reference's) at every width
    t = time.perf_counter()
    rng_p = np.random.default_rng(16)
    for bits in (1, 2, 3, 4, 5, 6, 8):
        v = rng_p.integers(0, 1 << bits, (512, 4096)).astype(np.uint16)
        for g, w in zip(pack_planes_on(v, bits, dev),
                        pack_planes_on(v, bits, "cpu")):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"pack_planes_on at {bits} bits: the "
                                     f"card's words are not the CPU's")
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ap = argparse.ArgumentParser()
    model_init.add_args(ap)
    model, _, gen = model_init.init(ap.parse_args(
        ["-m", dst, "-l", str(SERVER_LEN)]), max_batch_size=SERVER_BATCH)
    torch.cuda.synchronize()
    total = torch.cuda.memory_allocated() - m0
    peak = torch.cuda.max_memory_allocated() - m0
    c = gen.cache
    cache_b = sum(x.numel() * x.element_size() for x in (
        c.k_data, c.k_scales, c.v_data, c.v_scales) if x is not None)
    ctx = c.num_pages * c.page_size
    bpw = convert_bits(dst, CONVERT_LAYERS)["bpw"]
    plan, lines = quiet(fit_hbm.main, ["-m", dst, "-b", f"{bpw:.4f}", "-hb",
                                       "8", "-ctx", str(ctx), "-tp", "1"])
    for l in lines:
        log(f"[cli] fit_hbm: {l}")
    out["setup"] = {
        "allocated_bytes": total, "peak_bytes": peak,
        "cache_bytes": cache_b,
        "model_bytes": total - cache_b, "context": ctx,
        "pages": c.num_pages, "max_seq_len": gen.max_seq_len,
        "predicted_weights_bytes": plan["weights_bytes"],
        "predicted_cache_bytes": plan["cache_bytes"],
        "weights_ratio": (total - cache_b) / plan["weights_bytes"],
        "cache_ratio": cache_b / plan["cache_bytes"]}
    s = out["setup"]
    log(f"[cli] model_init.init(-m convert_out -l {SERVER_LEN}, "
        f"max_batch_size {SERVER_BATCH}) on {card}: "
        f"{c.num_pages} pages ({ctx} tokens, bf16), max_len "
        f"{gen.max_seq_len}; torch.cuda.memory_allocated: model and "
        f"generator {s['model_bytes'] / GIB:.3f} GiB against fit_hbm's "
        f"weights {s['predicted_weights_bytes'] / GIB:.3f} GiB (ratio "
        f"{s['weights_ratio']:.3f}), cache {cache_b / GIB:.3f} GiB against "
        f"{s['predicted_cache_bytes'] / GIB:.3f} (ratio "
        f"{s['cache_ratio']:.3f}) at {bpw:.4f} bpw; peak during init "
        f"{peak / GIB:.3f} GiB, {(peak - total) / GIB:.3f} GiB above what "
        f"stays allocated; "
        f"plane words packed on the card equal the CPU's at 1-8 bits")
    seconds["setup"] = time.perf_counter() - t

    # (b) the websocket server: a warm round, then the measured one
    t = time.perf_counter()
    steps = {}
    tok = id_tokenizer()
    gen.tokenizer = tok
    server = WebSocketServer(gen)
    rng = np.random.default_rng(16)
    server_round(server, server_prompts(rng), stop_extra=True)      # warm
    prompts = server_prompts(rng)
    free0 = gen._free_capacity()
    g0 = graph_counts(gen)
    steps["warm"] = time.perf_counter() - t
    torch.cuda.synchronize()
    zero_counts()
    r = server_round(server, prompts, stop_extra=True)
    torch.cuda.synchronize()
    launches = arch_counts()
    g_round = graph_counts(gen, g0)
    if gen.num_remaining_jobs() or gen._free_capacity() != free0:
        raise AssertionError(f"server: {gen.num_remaining_jobs()} jobs left, "
                             f"{gen._free_capacity()} of {free0} pages free")
    if not (launches["qmm"] and launches["paged_decode_attn"]):
        raise AssertionError(f"server round launches {launches}")
    ttft = np.nanpercentile(r["first_chunk_ms"], 50)
    # each prompt alone through generator.generate (graphed)
    t1 = time.perf_counter()
    main = prompts[:SERVER_REQUESTS]
    alone = [gen.generate(tok.encode(p), max_new_tokens=SERVER_NEW,
                          settings=Settings.greedy()) for p in main]
    steps["alone"] = time.perf_counter() - t1
    # a graphed round with no stop: its texts must be generate()'s for the
    # same prompts as one batch, bitwise (what each request was sent is its
    # own job's)
    t1 = time.perf_counter()
    r_g = server_round(server, prompts, stop_extra=False)
    batch_g = gen.generate([tok.encode(p) for p in main],
                           max_new_tokens=SERVER_NEW,
                           settings=Settings.greedy())
    if batch_g != r_g["texts"]:
        raise AssertionError("server: the graphed round's texts are not "
                             "generate's for the same batch")
    steps["batch"] = time.perf_counter() - t1
    # the measured round again, stop included, through an eager generator of
    # the served model, and the first prompt alone: kernels 1 and 3 held on
    # their inputs at every batch bucket the measured round ran (its 9 live
    # jobs, then 8 after the stop, and 1)
    t1 = time.perf_counter()
    gen_e = DynamicGenerator(gen.model, PagedKVCache.alloc(
        model.static.num_layers, c.num_pages, model.static.num_kv_heads,
        model.static.head_dim, "bf16", device=dev), tok,
        max_batch_size=gen.max_batch_size, max_seq_len=gen.max_seq_len,
        prescale=False, graphs=False)
    with held_kernels("cli server") as held:
        r_e = server_round(WebSocketServer(gen_e), prompts,
                           stop_extra=True)
        alone_e = gen_e.generate(tok.encode(main[0]),
                                 max_new_tokens=SERVER_NEW,
                                 settings=Settings.greedy())
    steps["eager"] = time.perf_counter() - t1
    if alone_e != alone[0]:
        raise AssertionError("server: prompt 0 alone, eager != graphed")
    held_out = check_held("cli server", gen.model, held,
                          rows=(1, SERVER_REQUESTS,
                                _bucket(SERVER_REQUESTS + 1)))
    t1 = time.perf_counter()
    gaps = {}
    parts = alone_check("server round", gen.model, tok, main, r["texts"],
                        alone, gaps)
    parts_e = alone_check("eager server round", gen.model, tok, main,
                          r_e["texts"], alone, gaps)
    steps["ties"] = time.perf_counter() - t1
    out["server"] = {
        "tokens": r["tokens"], "seconds": r["seconds"],
        "tokens_per_s": r["tokens"] / r["seconds"],
        "requests_per_s": SERVER_REQUESTS / r["seconds"],
        "p50_first_chunk_ms": ttft, "first_chunk_ms": r["first_chunk_ms"],
        "launches": launches, "step_graphs": g_round,
        "stopped_after_tokens": r["stopped_at"],
        "stopped_text_tokens": r["stopped_text_tokens"],
        "equal_alone": sum(p is None for p in parts),
        "equal_alone_eager": sum(p is None for p in parts_e),
        "near_ties": {str(k): v for k, v in gaps.items()},
        "held": held_out, "seconds_by_part": steps}
    v = out["server"]
    log(f"[cli] websocket server on {card}: {SERVER_REQUESTS} concurrent "
        f"greedy requests ({SERVER_PROMPT}-token prompts, {SERVER_NEW} new "
        f"tokens) with echo / estimate_token / lefttrim_token beside them "
        f"and an extra request stopped after {r['stopped_at']} tokens: "
        f"{r['tokens']} tokens in {r['seconds'] * 1e3:.1f} ms = "
        f"{v['tokens_per_s']:.1f} tokens/s, {v['requests_per_s']:.2f} "
        f"requests/s, p50 time to first chunk {ttft:.1f} ms; launches "
        f"{launches}; step graphs {g_round}; texts equal to each prompt "
        f"alone: {v['equal_alone']} of {SERVER_REQUESTS} graphed, "
        f"{v['equal_alone_eager']} eager (the rest part at near-ties); a "
        f"graphed round with no stop bitwise generate()'s of the same "
        f"batch; the stopped job cancelled, every page back in the pool; seconds "
        + ", ".join(f"{k} {x:.1f}" for k, x in steps.items()))
    del server, gen, gen_e
    gc.collect()
    torch.cuda.empty_cache()
    seconds["server"] = time.perf_counter() - t

    # (c) test_inference
    t = time.perf_counter()
    zero_counts()
    ti, _ = quiet(test_inference.main, [
        "-m", dst, "-ed", "random", "-er", "4", "-el", "512", "-p",
        prompts[0], "-t", str(SERVER_NEW), "-ps", "--greedy"])
    ti_launches = arch_counts()
    ppl = ti["perplexity"]
    log(f"[cli] test_inference -ed random -er 4 -el 512 -p -t {SERVER_NEW} "
        f"-ps --greedy on {card}: perplexity {ppl:.4f} (random rows of a "
        f"random model), -p {ti['prompt_tokens_per_s']:.2f} tokens/s, -ps "
        f"{ti['speed_tokens_per_s']:.2f} tokens/s; launches {ti_launches}")
    if not np.isfinite(ppl):
        raise AssertionError(f"test_inference perplexity {ppl}")
    out["test_inference"] = {k: v for k, v in ti.items() if k != "text"}
    out["test_inference"]["launches"] = ti_launches
    gc.collect()
    torch.cuda.empty_cache()
    seconds["test_inference"] = time.perf_counter() - t

    # (d) estimate_kld and model_diff: A = the fp16 source, B = the EXL2;
    # the CLI once as a user runs it, then its parts on the loaded models
    t = time.perf_counter()
    kld, _ = quiet(estimate_kld.main, ["-ma", src, "-mb", dst])
    t1 = time.perf_counter()
    a = Model.from_dir(src, device=dev)
    load_a = time.perf_counter() - t1
    rng_ids = np.random.default_rng(0)
    ids = rng_ids.integers(0, VOCAB, (1, 64)).astype(np.int32)
    diff, _ = quiet(model_diff.diff, *model_diff.hidden_states(a, ids),
                        *model_diff.hidden_states(model, ids))
    rows = estimate_kld._rows(ByteTokenizer(), None, 2, 512, 0)
    same, _ = quiet(estimate_kld.compare, a, a, rows)
    log(f"[cli] estimate_kld -ma convert_src -mb convert_out on {card}: "
        f"mean KLD {kld['mean_kld']:.6f}, max {kld['max_kld']:.5f}, top-1 "
        f"{100 * kld['top1']:.2f} % (8 random rows of 512); model_diff "
        f"(64 tokens): KLD {diff['kld']:.6f}, top-1 "
        f"{100 * diff['top1']:.2f} %, MSE by layer " + ", ".join(
            f"{n} {m:.3g}" for n, m, _ in diff["layers"])
        + f"; A against A: KLD {same['mean_kld']:.2e}, top-1 "
        f"{100 * same['top1']:.2f} %; the fp16 source loads in "
        f"{load_a:.1f} s")
    if not (same["mean_kld"] <= KLD_SELF and same["top1"] == 1.0):
        raise AssertionError(f"estimate_kld A against A {same}")
    if not all(np.isfinite(x) for x in (kld["mean_kld"], kld["max_kld"],
                                        diff["kld"])):
        raise AssertionError(f"estimate_kld {kld}, model_diff {diff['kld']}")
    out["quality"] = {"estimate_kld": kld, "model_diff": diff,
                      "self": same, "source_load_s": load_a}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    seconds["quality"] = time.perf_counter() - t

    # (e) fpxify the fp16 source
    t = time.perf_counter()
    fpx = {}
    for e, m in FPX_FORMATS:
        fx = Model(fpxify(a.weights, e, m), a.static, a.config)
        fpx[f"e{e}m{m}"], _ = quiet(estimate_kld.compare, a, fx, rows)
        del fx
    k = [fpx[f"e{e}m{m}"]["mean_kld"] for e, m in FPX_FORMATS]
    log(f"[cli] fpxify of the fp16 source on {card}: mean KLD against it "
        + ", ".join(f"{n} {v['mean_kld']:.6f} (top-1 "
                    f"{100 * v['top1']:.2f} %)" for n, v in fpx.items()))
    if not 0 < k[0] < k[1] < k[2]:
        raise AssertionError(f"fpxify KLD does not rise as bits fall: {k}")
    out["fpx"] = fpx
    seconds["fpx"] = time.perf_counter() - t

    # (f) rank_reduce_linear on layer 0's MLP
    t = time.perf_counter()
    rr = {}
    for name in ("gate", "up", "down"):
        lin = getattr(a.weights.layers[0].mlp, name)
        wmax = lin.weight.float().abs().max()
        for frac in (1.0, 0.5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            red = rank_reduce_linear(lin, frac)
            torch.cuda.synchronize()
            rr[f"{name}_{frac}"] = {
                "seconds": time.perf_counter() - t1,
                "rel_err": ((red.weight.float() - lin.weight.float()).abs()
                            .max() / wmax).item()}
    log(f"[cli] rank_reduce_linear on layer 0's MLP (4096x11008, f64 SVD) "
        f"on {card}: " + ", ".join(
            f"{n} {v['rel_err']:.2e} of max |w| in {v['seconds']:.2f} s"
            for n, v in rr.items()))
    bad = {n: v for n, v in rr.items()
           if n.endswith("_1.0") and not v["rel_err"] <= RR_TOL}
    if bad:
        raise AssertionError(f"rank fraction 1.0 off the weight: {bad}")
    out["rank_reduce"] = rr
    del a
    gc.collect()
    torch.cuda.empty_cache()
    seconds["rank_reduce"] = time.perf_counter() - t
    out["seconds_by_step"] = seconds
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] phase 16: {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    return out


# --------------------------------------------------------------- phase 17

# Llama-2-7B width (phase 5's geometry) at 8 of its 32 layers, and
# Mixtral-8x7B's at 2 of its 32: the two-rank legs
TP_LLAMA = dict(vocab=VOCAB, hidden=HIDDEN, layers=8, heads=HEADS,
                kv_heads=HEADS, inter=INTER)
TP_MIXTRAL = dict(MIXTRAL, layers=2)
TP_JOBS, TP_PROMPT, TP_PAGES = 4, 8, 8
TP_NEW = {"dense": 32, "ep": 16}
TP_SEED = {"dense": 17, "ep": 18}
# the column widths of kernel 1's launches on a rank of the dense leg
# (every linear at N / 2: q, k, v, o, down 2048, gate and up 5504, the head
# 16000; its KV heads in kernel 3: 16 of 32), and of the expert-parallel
# leg (q and o 2048, k and v 512, the head 16000, whole experts' w1 / w3
# 14336 and w2 4096 in the prefill's capacity dispatch; the gated entry on
# them in decode; 4 of 8 KV heads)
TP_SHARD_N = {2048, 5504, 16000}
TP_EP_SHARD_N = {512, 2048, 4096, 14336, 16000}
TP_EP_GATED = [(4096, 14336), (14336, 4096)]
# a rank's logits against one process's, of max |logit|, up to the first
# differing token: the gate decode_vs_prefill sets for a path that rounds
# in another order
TP_LOGITS_TOL = 0.02
# kernels 2 and 3 at more than 16 query heads a KV head (phase 17a)
FAULT1_ATTN = [(b, hq, 1, p, 0.0, 0) for b in (1, 4) for hq in (48, 22)
               for p in (255, 1500)]
FAULT1_PAGED = [dict(kind=k, b=b, hkv=1, hq=hq, cap=0.0, win=0)
                for k in PAGED_KINDS for hq in (48, 22) for b in (1, 16)]


# kernel 3's mma template at the grouped-query heads PERF.md's kernel table
# times: StarCoder-15B's 48/1 and Qwen2.5-VL's 28/4, every kind, b 1 and 16
GQA_PAGED = [dict(kind=k, b=b, hkv=hkv, hq=hq, cap=0.0, win=0)
             for hq, hkv in ((48, 1), (28, 4)) for k in PAGED_KINDS
             for b in (1, 16)]


def gqa_paged(dev, rate) -> int:
    """`python3 chip_smoke.py gqa-paged`: build csrc/paged_attn.cu alone and
    run GQA_PAGED through phase 6 (each case against the plain version
    within ATTN_TOL, timed); one JSON line of µs a case. It uses only what
    the package had before the q4 fragments, so the same file run from
    another checkout times that checkout's kernel."""
    from exllamav2_tpu_torch import _build
    t0 = time.perf_counter()
    rep = _build.build_all(["paged_attn"]).get("paged_attn")
    log(f"[build] paged_attn compiled in {time.perf_counter() - t0:.1f} s"
        if rep is not None else "[build] paged_attn: built already")
    for line in (rep or "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] paged_attn: {line.strip()}")
    rows, err = phase_paged(dev, rate, GQA_PAGED, "gqa-paged")
    print(json.dumps({"root": HERE, "max_abs_err": err, "us": {
        f"{r['hq']}/{r['hkv']} {r['kind']} b{r['b']}": r["ms"] * 1e3
        for r in rows}}))
    return 0


def tp_model(mode: str, dev):
    return arch_model(TP_LLAMA if mode == "dense" else TP_MIXTRAL, dev,
                      seed=TP_SEED[mode])[0]


def tp_prompts(mode: str, k: int) -> list:
    """Round k's prompts (a new draw each round: no page of a round is
    reused by the next)."""
    rng = np.random.default_rng(100 * TP_SEED[mode] + k)
    return [rng.integers(3, VOCAB, TP_PROMPT).astype(np.int32)
            for _ in range(TP_JOBS)]


def tp_generator(model, dev, mesh=None):
    from exllamav2_tpu_torch.cache_paged import PagedKVCache
    from exllamav2_tpu_torch.generator.dynamic import DynamicGenerator
    st = model.static
    cache = PagedKVCache.alloc(st.num_layers, TP_PAGES, st.num_kv_heads,
                               st.head_dim, "bf16", device=dev)
    return DynamicGenerator(model, cache, id_tokenizer(),
                            max_batch_size=TP_JOBS, mesh=mesh)


def tp_serve(gen, prompts, new: int, logits: bool = False):
    """Greedy jobs of `prompts` -> (their new tokens, ms a decode step: the
    time after the first iterate, which prefills, over the steps the
    longest job took after it; with `logits` also each job's logits at each
    of its new tokens, [new, vocab] f32: a token an iterate, no bursts)."""
    from exllamav2_tpu_torch.generator.dynamic import DynamicJob
    from exllamav2_tpu_torch.generator.sampler import Settings

    def sync():
        if gen.device.type == "cuda":
            torch.cuda.synchronize(gen.device)

    def emitted():
        return max(len(j.sequence) - j.prompt_len for j in jobs)

    def step():
        for r in gen.iterate():
            if r.get("logits") is not None:
                seen[ids[id(r["job"])]].append(r["logits"][0])

    jobs = [gen.enqueue(DynamicJob(p, max_new_tokens=new, return_logits=logits,
                                   settings=Settings.greedy()))
            for p in prompts]
    ids, seen = {id(j): i for i, j in enumerate(jobs)}, [[] for _ in jobs]
    step()
    sync()
    t, first = time.perf_counter(), emitted()
    while any(j.status != "done" for j in jobs):
        step()
    sync()
    steps = emitted() - first
    return ([j.sequence[j.prompt_len:].tolist() for j in jobs],
            (time.perf_counter() - t) / steps * 1e3 if steps else None,
            [np.stack(x) for x in seen] if logits else None)


def tp_rank(mode: str, device: str) -> int:
    """One rank of phase 17's two-rank world (started by phase_tp through
    parallel/launch.py, each rank a process on cuda:0, gloo between them):
    the model of `mode` built from its seed, sharded by
    DynamicGenerator(mesh=); round 0 under held_kernels (kernels 1 and 3,
    and the gated kernel 1 of the expert-parallel layers, held against their
    plain versions on the rank's own inputs at its shard's shapes), its
    tokens and per-step logits saved to build/tp_<mode>.<rank>.pt; round 1
    with its launch counts (zeroed just before, read just after) and its
    ms a decode step. Prints one JSON line: the held shapes and worst
    errors, the counts, the step time."""
    from exllamav2_tpu_torch.parallel.sharding import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    mesh = make_mesh(2, device=dev, backend="gloo", timeout=300)
    gen = tp_generator(tp_model(mode, dev), dev, mesh)
    new = TP_NEW[mode]
    with held_kernels(f"tp-{mode} rank {mesh.rank}") as held:
        toks0, _, logits0 = tp_serve(gen, tp_prompts(mode, 0), new, True)
    torch.save({"tokens": toks0, "logits": logits0},
               os.path.join(OUT_DIR, f"tp_{mode}.{mesh.rank}.pt"))
    zero_counts()
    toks, step_ms, _ = tp_serve(gen, tp_prompts(mode, 1), new)
    counts = arch_counts()
    mlp = gen.model.weights.layers[0].mlp
    qmm = held["qmm"]
    print(json.dumps({
        "rank": mesh.rank, "fused": gen._tp_fused, "mlp": type(mlp).__name__,
        "experts": len(getattr(mlp, "w1", [])), "tokens": toks,
        "launches": counts, "step_ms": step_ms,
        "qmm_n": sorted({k[2] for k in qmm if len(k) == 3}),
        "gated_kn": sorted({k[1:3] for k in qmm if k[3:] == ("gated",)}),
        "gated_off": sum(k[3:] == ("gated off",) for k in qmm),
        "paged_hkv": sorted({k[2] for k in held["paged"]}),
        "held_shapes": len(qmm) + len(held["paged"]),
        "worst_qmm": max(qmm.values()),
        "worst_paged": max(held["paged"].values())}), flush=True)
    return 0


def tp_agree(mode, got, want) -> list:
    """Round 0 of the ranks (`got`: tokens and per-step logits) against one
    process's (`want`) on the same weights and prompts: each job's logits
    within TP_LOGITS_TOL of max |logit| at every step up to its first
    differing token, and that token on a near-tie of one process's logits
    there (its logit under the top one by less than TIE_GAP of max |logit|),
    else the phase fails. -> per job (steps compared, worst rel err, the
    first differing step or None, its gap)."""
    out = []
    for j, (ta, tb, la, lb) in enumerate(zip(got["tokens"], want["tokens"],
                                             got["logits"], want["logits"])):
        d = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
        n = len(tb) if d is None else d + 1
        rel = max(float(np.abs(la[i] - lb[i]).max() / np.abs(lb[i]).max())
                  for i in range(n))
        gap = None if d is None else float(
            (lb[d].max() - lb[d][ta[d]]) / np.abs(lb[d]).max())
        log(f"[tp-{mode}] job {j}: logits against one process's over {n} "
            f"steps: rel err {rel:.2e} (limit {TP_LOGITS_TOL}); "
            + ("tokens equal" if d is None else
               f"parts at new token {d} ({ta[d]} on the ranks, {tb[d]} one "
               f"process): gap {gap:.2e} of max |logit| (limit {TIE_GAP})"))
        if not (rel <= TP_LOGITS_TOL and (gap is None or gap < TIE_GAP)):
            raise AssertionError(f"tp-{mode} job {j}: logits rel err {rel}, "
                                 f"gap {gap}")
        out.append((n, rel, d, gap))
    return out


def tp_leg(mode: str, dev) -> dict:
    """Two ranks of `mode` on the card against one process on the same
    weights and prompts: every rank's kernels held on its own inputs at its
    shard's shapes; the ranks' round-0 tokens and logits equal each other's
    (every rank gathers the same bytes) and agree with the process's
    (tp_agree: a rank sizes kernel 1's K split and kernel 3's sequence
    split for its own shard, so its sums run in another order)."""
    from exllamav2_tpu_torch.parallel.launch import launch
    t0 = time.perf_counter()
    outs = launch([os.path.abspath(__file__), "tp-rank", mode, str(dev)], 2,
                  timeout=600, cwd=HERE)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    t_ranks = time.perf_counter() - t0
    model = tp_model(mode, dev)
    gen = tp_generator(model, dev)
    toks0, _, logits0 = tp_serve(gen, tp_prompts(mode, 0), TP_NEW[mode],
                                 True)
    # a warm round of the measured length: its step graphs are captured
    tp_serve(gen, tp_prompts(mode, 2), TP_NEW[mode])
    want, step_ms, _ = tp_serve(gen, tp_prompts(mode, 1), TP_NEW[mode])
    shard = {"dense": (TP_SHARD_N, [], {16}),
             "ep": (TP_EP_SHARD_N, TP_EP_GATED, {4})}[mode]
    for r in ranks:
        c = r["launches"]
        log(f"[tp-{mode}] rank {r['rank']}: fused={r['fused']} mlp "
            f"{r['mlp']} ({r['experts']} experts); launches {c}; held on "
            f"its own inputs at {r['held_shapes']} shapes: kernel 1 at N "
            f"{r['qmm_n']}, gated at (k, n) {r['gated_kn']} ("
            f"{r['gated_off']} with the flag clear), worst rel err "
            f"{r['worst_qmm']:.2e} (limit {QMM_TOL}); kernel 3 at "
            f"{r['paged_hkv']} KV heads, worst {r['worst_paged']:.2e} "
            f"(limit {ATTN_PATH_TOL:.2e}); {r['step_ms']:.2f} ms a step of "
            f"{TP_JOBS} jobs (gloo through the host, not NVLink)")
        if not (r["fused"] and c["qmm"] > 0 and c["paged_decode_attn"] > 0
                and r["worst_qmm"] <= QMM_TOL
                and r["worst_paged"] <= ATTN_PATH_TOL):
            raise AssertionError(f"tp-{mode} rank {r['rank']}: {r}")
        if (set(r["qmm_n"]), [tuple(x) for x in r["gated_kn"]],
                set(r["paged_hkv"])) != shard:
            raise AssertionError(f"tp-{mode} rank {r['rank']}: held at "
                                 f"{r['qmm_n']} {r['gated_kn']} "
                                 f"{r['paged_hkv']}, want {shard}")
        if mode == "ep" and (r["mlp"] != "EPMoEWeights" or r["experts"] != 4
                             or c["qmm_gated"] == 0):
            raise AssertionError(f"tp-ep rank {r['rank']}: {r}")
    got = [torch.load(os.path.join(OUT_DIR, f"tp_{mode}.{r}.pt"),
                      weights_only=False) for r in (0, 1)]
    same_ranks = (got[0]["tokens"] == got[1]["tokens"]
                  and ranks[0]["tokens"] == ranks[1]["tokens"] and all(
                      np.array_equal(a, b) for a, b in
                      zip(got[0]["logits"], got[1]["logits"])))
    log(f"[tp-{mode}] the ranks' tokens and logits bitwise equal: "
        f"{same_ranks}; one process {step_ms:.2f} ms a step (graphed); "
        f"the two ranks took {t_ranks:.1f} s with their start")
    if not same_ranks:
        raise AssertionError(f"tp-{mode}: the ranks differ")
    agree = tp_agree(mode, got[0], {"tokens": toks0, "logits": logits0})
    del gen, model
    torch.cuda.empty_cache()
    return {"ranks": ranks, "one_process_step_ms": step_ms,
            "one_process_tokens": want, "agree": agree,
            "seconds": time.perf_counter() - t0}


def dp_leg(dev) -> dict:
    """DataParallelGenerator(dp=2, tp=1) with both replicas on the card:
    the plain generator's texts, and both replicas serve."""
    from exllamav2_tpu_torch.generator.sampler import Settings
    from exllamav2_tpu_torch.parallel.dp_server import DataParallelGenerator
    model = tp_model("dense", dev)
    prompts = tp_prompts("dense", 3)
    kw = dict(max_new_tokens=TP_NEW["dense"], settings=Settings.greedy())
    # the dispatcher sends jobs 0 and 2 to replica 0, 1 and 3 to replica 1:
    # the plain generator serves the same batches
    plain = [None] * len(prompts)
    for half in (0, 1):
        idx = range(half, len(prompts), 2)
        for i, text in zip(idx, tp_generator(model, dev).generate(
                [prompts[i] for i in idx], **kw)):
            plain[i] = text
    dpg = DataParallelGenerator(model, id_tokenizer(), num_pages=TP_PAGES,
                                dp=2, devices=[dev, dev],
                                max_batch_size=TP_JOBS)
    t = time.perf_counter()
    texts = dpg.generate(prompts, **kw)
    dt = time.perf_counter() - t
    same = texts == plain
    log(f"[dp] 2 replicas on {dev}: jobs served {dpg.served}; texts equal "
        f"the plain generator's: {same}; {dt:.2f} s")
    if not (same and dpg.served == [2, 2]):
        raise AssertionError(f"dp: served {dpg.served}, same {same}")
    return {"served": dpg.served, "seconds": dt}


def module_bytes(module) -> int:
    """Bytes of the distinct storages a module's buffers hold."""
    seen = {}
    for b in module.buffers():
        st = b.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def shard_memory(tag: str, cfg: dict, layers: int, dev) -> dict:
    """The bytes rank 0 of a tp = 2 mesh holds (parallel/sharding
    .shard_model: what splits is split, the rest whole) against one
    process's, from a 2-layer cut: a layer's, the rest's (embedding, head,
    tables) and at the model's full depth `layers`, with the KV cache's
    bytes a token."""
    from exllamav2_tpu_torch.parallel import sharding as S
    model = arch_model(dict(cfg, layers=2), dev)[0]
    mesh = S.Mesh(tp=2, dp=1, rank=0, tp_rank=0, dp_rank=0, tp_group=None,
                  dp_group=None, backend="gloo", device=dev)
    w, st = S.shard_model(model.weights, model.static, mesh)
    whole_l, rank_l = (module_bytes(x.layers[0]) for x in (model.weights, w))
    whole_r = module_bytes(model.weights) - 2 * whole_l
    rank_r = module_bytes(w) - 2 * rank_l
    kv = 2 * layers * model.static.head_dim * 2
    out = {"fused": S.tp_fusable(model.weights, model.static, 2),
           "heads_split": S.heads_split(w),
           "whole_gb": (whole_r + layers * whole_l) / 1e9,
           "rank_gb": (rank_r + layers * rank_l) / 1e9,
           "layer_ratio": rank_l / whole_l,
           "kv_bytes_a_token": {"whole": kv * model.static.num_kv_heads,
                                "rank": kv * st.num_kv_heads}}
    log(f"[tp-memory] {tag} at {layers} layers, tp 2 (fused "
        f"{out['fused']}, heads split {out['heads_split']}): a rank holds "
        f"{out['rank_gb']:.3f} of {out['whole_gb']:.3f} GB "
        f"({out['rank_gb'] / out['whole_gb']:.1%}; a layer "
        f"{out['layer_ratio']:.1%}); KV cache {out['kv_bytes_a_token']} "
        f"bytes a token")
    del model, w
    torch.cuda.empty_cache()
    return out


def phase_tp(dev, rate):
    """Phase 17: (a) kernels 2 and 3 at 48 and 22 query heads on one KV
    head; (b) two tensor-parallel ranks at Llama-2-7B width; (c) two
    expert-parallel ranks at Mixtral's; (d) two data-parallel replicas;
    (e) a rank's memory on the fused path and on the fallback."""
    out = {}
    t0 = time.perf_counter()
    out["attn"], out["attn_err"] = phase_attn(dev, rate, FAULT1_ATTN,
                                              "fault1-attn")
    out["paged"], out["paged_err"] = phase_paged(dev, rate, FAULT1_PAGED,
                                                 "fault1-paged")
    log(f"[time] phase 17a: {time.perf_counter() - t0:.1f} s")
    out["dense"] = tp_leg("dense", dev)
    out["ep"] = tp_leg("ep", dev)
    out["dp"] = dp_leg(dev)
    # the fused path's memory a rank against the fallback's (StarCoder's
    # one KV head keeps q, k, v and the cache whole on every rank)
    out["memory"] = {
        "llama2_7b": shard_memory("llama2-7b", TP_LLAMA, LAYERS, dev),
        "starcoder_15b": shard_memory("starcoder-15b", STARCODER, 40, dev)}
    out["launches"] = {f"tp_{m}_rank{r['rank']}": r["launches"]
                       for m in ("dense", "ep") for r in out[m]["ranks"]}
    return out


# --------------------------------------------------------------- phase 18

TRAINED_TINY = os.path.join(HERE, "tests", "fixtures", "trained_tiny")
# step 0 of the trainer, the card (bf16 x bf16 -> f32 products, BF16Dot's
# gradient) against the CPU (f32 products) on the same batch and init
TRAIN_LOSS_TOL = 0.01       # absolute, of a loss of 6.11
TRAIN_GRAD_TOL = 0.05       # each gradient, of its max |grad|
TRAIN_FINAL_LOSS = 0.5      # after 1,200 steps (ln 384 = 5.95 is chance)
# BF16Dot calls in one training forward of the fixture: 2 layers x (q, k,
# v, o, gate, up, down and the two attention products) and the head
TRAIN_DOTS = 2 * 9 + 1
# the examples whose Settings are greedy: their card tokens are held to
# the CPU's (equal, or parting at a near-tie on the card's own logits)
GREEDY_EXAMPLES = ("bulk_inference", "dynamic_gen", "inference_async",
                   "inference_dedup", "inference_filters",
                   "inference_grammar", "inference_speculative",
                   "multimodal_grounding", "multimodal_video")


def script_counts() -> dict:
    """Launch counts of kernels 1-4 and G1."""
    from exllamav2_tpu_torch.convert import gptq as G
    c = arch_counts()
    c["qmm_w4a8"] = launch_counts()["qmm_w4a8"]
    c["gptq"] = G.LAUNCHES["gptq"]
    return c


def zero_script_counts() -> None:
    from exllamav2_tpu_torch.convert import gptq as G
    zero_counts()
    G.LAUNCHES["gptq"] = 0


@contextlib.contextmanager
def captured_jobs(logits: bool = False):
    """While on, every DynamicJob made is recorded: yields a list of (job,
    [logit rows, one a new token]) filled as the jobs run. The rows are
    there with logits=True, which makes every job ask for its logits (and
    so takes the generator's one-token steps: no bursts)."""
    from exllamav2_tpu_torch.generator import dynamic as GD
    jobs, rows_of = [], {}
    init, iterate = GD.DynamicJob.__init__, GD.DynamicGenerator.iterate

    def init_logged(self, *a, **kw):
        if logits:
            kw["return_logits"] = True
        init(self, *a, **kw)
        rows = []
        jobs.append((self, rows))
        rows_of[id(self)] = rows

    def iterate_logged(self):
        results = iterate(self)
        for r in results:
            if r.get("logits") is not None and r.get("serial") in rows_of:
                rows_of[r["serial"]].append(
                    torch.as_tensor(r["logits"]).float().reshape(-1).cpu())
        return results

    GD.DynamicJob.__init__, GD.DynamicGenerator.iterate = \
        init_logged, iterate_logged
    try:
        yield jobs
    finally:
        GD.DynamicJob.__init__, GD.DynamicGenerator.iterate = init, iterate


def job_tokens(jobs) -> list:
    return [np.asarray(j.sequence[j.prompt_len:]).tolist() for j, _ in jobs]


def jobs_agree(tag, card, cpu) -> list:
    """The card's greedy jobs against the CPU's, in the order they were
    made: each the same new tokens, or the first differing token at a
    near-tie on the card's own logits of that step (the two tokens ranked
    first and second, TIE_GAP of max |logit| apart). -> [(job, step,
    gap)] of the parted jobs."""
    if len(card) != len(cpu):
        raise AssertionError(f"{tag}: {len(card)} jobs on the card, "
                             f"{len(cpu)} on the CPU")
    parts = []
    for k, ((jc, rows), (jp, _)) in enumerate(zip(card, cpu)):
        a = np.asarray(jc.sequence[jc.prompt_len:])
        b = np.asarray(jp.sequence[jp.prompt_len:])
        if np.array_equal(a, b):
            continue
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if n >= min(len(a), len(b)) or n >= len(rows):
            raise AssertionError(f"{tag} job {k}: card {a.tolist()} cpu "
                                 f"{b.tolist()} part where a job ends")
        row = rows[n]
        top = torch.topk(row, 2)
        gap = ((top.values[0] - top.values[1]) / row.abs().max()).item()
        if sorted(top.indices.tolist()) != sorted([int(a[n]), int(b[n])]) \
                or not gap < TIE_GAP:
            raise AssertionError(f"{tag} job {k}: card and CPU part at "
                                 f"step {n} ({a[n]} / {b[n]}), top-2 "
                                 f"{top.indices.tolist()} gap {gap:.3g}")
        parts.append((k, n, gap))
    return parts


def train_step0(dev) -> dict:
    """(a) One step of the trainer on the card against the CPU twin's."""
    from exllamav2_tpu_torch.cli import train_fixture as TF
    from exllamav2_tpu_torch.ops import qmm as Q
    ids = next(TF.batches(TF.corpus_tokens(), np.random.default_rng(7), 8))
    out, grads, loss = {}, {}, {}
    calls = [0]
    real = Q.BF16Dot.apply

    def counted(*a):
        calls[0] += 1
        return real(*a)

    for d in ("cpu", dev):
        tmpl, st, pp = TF.init_model(7, d)
        w = TF.to_weights(tmpl, pp)
        zero_script_counts()
        calls[0] = 0
        Q.BF16Dot.apply = counted
        try:
            lo = TF.loss_fn(w, st, torch.as_tensor(ids, device=d))
            lo.backward()
        finally:
            del Q.BF16Dot.apply
        if d == dev:
            torch.cuda.synchronize()
            out["launches"] = script_counts()
            out["bf16_dot_calls"] = calls[0]
        loss[str(d)] = lo.item()
        grads[str(d)] = {n: p.grad.float().cpu() for n, p in pp.items()
                         if p.grad is not None}
    cpu, card = grads["cpu"], grads[str(dev)]
    rel = {n: ((card[n] - cpu[n]).abs().max() / cpu[n].abs().max()).item()
           for n in cpu}
    out.update(loss_cpu=loss["cpu"], loss_card=loss[str(dev)],
               grad_rel=rel, grad_rel_worst=max(rel.values()))
    log(f"[scripts] train step 0 on the card against the CPU twin (same "
        f"batch, same init): loss {loss[str(dev)]:.6f} / {loss['cpu']:.6f} "
        f"(limit {TRAIN_LOSS_TOL}), gradients of {len(rel)} tensors, worst "
        f"{out['grad_rel_worst']:.2e} of max |grad| (limit "
        f"{TRAIN_GRAD_TOL}); BF16Dot calls {calls[0]} (forward), "
        f"hand-kernel launches {out['launches']}")
    if len(rel) != 21 or set(card) != set(cpu):
        raise AssertionError(f"train: gradients of {sorted(card)}")
    if not (abs(loss[str(dev)] - loss["cpu"]) <= TRAIN_LOSS_TOL
            and out["grad_rel_worst"] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"train step 0: card against CPU {out}")
    if out["bf16_dot_calls"] != TRAIN_DOTS:
        raise AssertionError(f"train: {calls[0]} BF16Dot calls, want "
                             f"{TRAIN_DOTS}")
    if any(out["launches"].values()):
        raise AssertionError(f"train: hand kernels launched "
                             f"{out['launches']}")
    return out


def example_argv(name, files) -> tuple[list, str | None]:
    """(argv, stdin) of an example twin on the phase's checkpoints."""
    argv = ["-m", TRAINED_TINY]
    stdin = None
    if name == "inference_lora":
        argv += ["--lora_dir", files["lora"]]
    elif name == "inference_dedup":
        argv = ["-m", files["m4k"], "-l", "4096"]
    elif name == "minimal_chat":
        stdin = "What did the keeper write?\nAnd then?\n"
    elif name == "multimodal":
        argv = ["-m", files["qwen2"], "--image", files["image"]]
    elif name == "multimodal_grounding":
        argv = ["-m", files["qwen2"], "-i", files["image"], "-maxr", "48"]
    elif name == "multimodal_video":
        argv = ["-m", files["qwen2"]]
    elif name in ("bulk_inference", "dynamic_gen"):
        argv += ["-n", "8"]
    return argv, stdin


EXAMPLES = ("bulk_inference", "dynamic_gen", "inference", "inference_async",
            "inference_banned_strings", "inference_cfg", "inference_dedup",
            "inference_filters", "inference_grammar", "inference_lora",
            "inference_speculative", "inference_streaming", "minimal_chat",
            "multimodal", "multimodal_grounding", "multimodal_video")


def run_example(name, argv, stdin, device, logits=False):
    """An example twin's main in process -> (its result, stdout lines,
    the jobs it made, with their logits where `logits`)."""
    import importlib
    import io
    main = importlib.import_module(f"exllamav2_tpu_torch.cli.{name}").main
    old = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with captured_jobs(logits) as jobs:
            r, lines = quiet(main, argv + (["--device", "cpu"]
                                           if device == "cpu" else []))
    finally:
        sys.stdin = old
    return r, lines, jobs


def phase_scripts(dev, card):
    """Phase 18: the training path and the reference's remaining scripts
    as the port's twins, on the card."""
    import gc
    from exllamav2_tpu_torch.cli import (bench_serving, convert_serve_check,
                                         decomp_flagship, eval_trained,
                                         quality_eval)
    from exllamav2_tpu_torch.cli import train_fixture as TF
    from exllamav2_tpu_torch.models.model import Model
    from exllamav2_tpu_torch.utils.testing import (make_tiny_llama,
                                                   make_tiny_vlm,
                                                   write_random_lora)
    t_phase = time.perf_counter()
    out = {"card": card}
    seconds, launches = {}, {}

    def counted(key, fn, *a):
        zero_script_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a)
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t
        launches[key] = script_counts()
        return r

    # (a) training: step 0 against the CPU, then 1,200 steps
    out["train_step0"] = counted("train_step0", train_step0, dev)
    losses = []
    export_dir = os.path.join(OUT_DIR, "trained_tiny")
    weights, final = counted(
        "train", lambda: TF.train(steps=1200, batch=8, lr=3e-3, seed=7,
                                  device=dev, losses=losses,
                                  log=lambda s: log(f"[scripts] train {s}")))
    lt = torch.stack(losses).float().cpu()
    TF.export(weights, export_dir, final)
    del weights
    steps = len(losses)
    tr = {"steps": steps, "final_loss": final, "seconds": seconds["train"],
          "ms_per_step": seconds["train"] / steps * 1e3,
          "tokens_per_s": steps * 8 * TF.SEQ / seconds["train"],
          "first_loss": lt[0].item(), "launches": launches["train"],
          "losses_every_100": lt[::100].tolist()}
    out["train"] = tr
    log(f"[scripts] trained the fixture on {card}: {steps} steps (batch 8 x "
        f"{TF.SEQ} tokens) in {tr['seconds']:.1f} s with the set-up = "
        f"{tr['ms_per_step']:.3f} ms a step, {tr['tokens_per_s']:.0f} "
        f"tokens trained a second; loss {tr['first_loss']:.4f} -> "
        f"{final:.4f} (the committed fixture's recorded 0.0508; limit "
        f"{TRAIN_FINAL_LOSS}); hand-kernel launches {tr['launches']}; "
        f"exported to build/trained_tiny")
    if not (torch.isfinite(lt).all() and final < TRAIN_FINAL_LOSS):
        raise AssertionError(f"train: final loss {final}, finite "
                             f"{bool(torch.isfinite(lt).all())}")
    # 20 steps of the same loop under the profiler (batches on the card
    # beforehand): what the device does of a step
    tmpl, st, pp = TF.init_model(7, dev)
    w, opt = TF.to_weights(tmpl, pp), TF.optimizer(pp, 3e-3)
    draw = TF.batches(TF.corpus_tokens(), np.random.default_rng(8), 8)
    ids = [torch.as_tensor(next(draw), device=dev) for _ in range(21)]

    def run_steps(first, n):
        for i in range(first, first + n):
            opt.zero_grad()
            TF.loss_fn(w, st, ids[i]).backward()
            TF.update(opt, pp, 3e-3, 1200, i)

    run_steps(0, 1)
    per, busy, wall = profile_round(lambda: run_steps(1, 20))
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    tr["profile"] = {
        "wall_ms_per_step": wall * 1e3 / 20, "busy_ms_per_step": busy / 20,
        "idle_share": 1 - busy / (wall * 1e3),
        "kernels_per_step": sum(c for _, c in per.values()) / 20,
        "top": [(n[:60], ms / 20, c // 20) for n, (ms, c) in top]}
    pr = tr["profile"]
    log(f"[scripts] 20 training steps under the profiler on {card}: "
        f"{pr['wall_ms_per_step']:.3f} ms a step, device busy "
        f"{pr['busy_ms_per_step']:.3f} ms ({pr['kernels_per_step']:.0f} "
        f"kernels), idle share {pr['idle_share']:.3f}; the largest "
        f"(name, ms a step, launches a step): {pr['top']}")
    del w, opt, pp
    if any(tr["launches"].values()):
        raise AssertionError(f"train: hand kernels launched "
                             f"{tr['launches']}")

    # (b) eval_trained on the export and on trained_tiny, card and CPU
    ev = {}
    for tag, d in (("export", export_dir), ("trained_tiny", TRAINED_TINY)):
        with captured_jobs() as jobs:
            ev[tag], _ = counted(f"eval_{tag}", quiet, eval_trained.main,
                                 ["-m", d, "--out", os.path.join(
                                     OUT_DIR, f"eval_{tag}.json")])
        ev[tag + "_jobs"] = jobs
    cpu_argv = ["-m", TRAINED_TINY, "--device", "cpu", "--out",
                os.path.join(OUT_DIR, "eval_trained_tiny_cpu.json")]
    with captured_jobs() as cpu_jobs:
        ev_cpu, _ = quiet(eval_trained.main, cpu_argv)
    same = job_tokens(ev["trained_tiny_jobs"]) == job_tokens(cpu_jobs)
    parts = []
    if not same:
        # both again with every step's logits: each job parts at a near-tie
        # (the greedy text past the memorized code is the model's guess)
        with captured_jobs(True) as jl:
            quiet(eval_trained.main, ["-m", TRAINED_TINY, "--out",
                                      os.path.join(OUT_DIR, "eval_l.json")])
        with captured_jobs(True) as cl:
            quiet(eval_trained.main, cpu_argv)
        parts = jobs_agree("eval_trained", jl, cl)
    out["eval_trained"] = {
        t: {"pass_at_1": ev[t]["humaneval"].get("pass_at_1"),
            "mmlu": ev[t]["mmlu"].get("accuracy_line"),
            "launches": launches[f"eval_{t}"]}
        for t in ("export", "trained_tiny")}
    out["eval_trained"]["cpu"] = {
        "pass_at_1": ev_cpu["humaneval"].get("pass_at_1"),
        "mmlu": ev_cpu["mmlu"].get("accuracy_line"),
        "tokens_equal": same, "parts": parts}
    log(f"[scripts] eval_trained on {card}: export "
        f"{out['eval_trained']['export']}, trained_tiny "
        f"{out['eval_trained']['trained_tiny']}; the CPU twin on "
        f"trained_tiny {out['eval_trained']['cpu']} (parts: (job, step, "
        f"top-2 gap of max |logit|))")
    if not (launches["eval_trained_tiny"]["qmm"] == 0
            and launches["eval_trained_tiny"]["paged_decode_attn"] > 0):
        raise AssertionError(f"eval_trained launches "
                             f"{launches['eval_trained_tiny']}")

    # (c) convert_serve_check: converted on the card (G1), served greedy on
    # the card over a q4 cache, replayed forced on the CPU, checked
    root = os.path.join(OUT_DIR, "convert_serve_check")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    counted("csc_prepare", quiet, convert_serve_check.prepare, root, dev)
    csc, _ = counted("csc_flow", quiet, convert_serve_check.flow, root, "q4",
                     0.08, dev)
    out["convert_serve_check"] = {
        "check": csc["check"], "card_tokens_per_s":
        csc["greedy"]["tokens_per_s"],
        "launches": {"prepare": launches["csc_prepare"],
                     "flow": launches["csc_flow"]}}
    log(f"[scripts] convert_serve_check on {card}: converted on the card "
        f"(launches {launches['csc_prepare']}), greedy on the card "
        f"{csc['greedy']['tokens_per_s']} tokens/s (launches "
        f"{launches['csc_flow']}), forced replay on the CPU, check "
        f"{csc['check']}")
    if not (csc["check"]["ok"] and launches["csc_prepare"]["gptq"] > 0
            and launches["csc_flow"]["qmm"] > 0
            and launches["csc_flow"]["paged_decode_attn"] > 0):
        raise AssertionError(f"convert_serve_check {out['convert_serve_check']}")

    # (d) quality_eval on the card
    res, _ = counted("quality_eval", quiet, quality_eval.run,
                     os.path.join(OUT_DIR, "QUALITY.md"), None, dev)
    flat = [v for k in res for v in (res[k].values()
                                     if isinstance(res[k], dict) else [])]
    out["quality_eval"] = {"tables": res, "launches": launches["quality_eval"]}
    log(f"[scripts] quality_eval on {card}: trained fixture ppl bf16 "
        f"{res['t_ppl_dense']['bf16']:.4f}, q4 cache "
        f"{res['t_ppl_dense']['q4']:.4f}, 4.0 bpw "
        f"{res['t_ppl_q4']['bf16']:.4f}; KLD 4.0 / 6.0 bpw "
        f"{res['t_kld4']['kld_mean']:.5f} / {res['t_kld6']['kld_mean']:.5f}; "
        f"W4A8 decode ppl {res['t_w4a8']['ppl_exact']:.4f} -> "
        f"{res['t_w4a8']['ppl_w4a8']:.4f}; peaked q6 / q4 "
        f"{res['ppl_peaked']['q6']:.4f} / {res['ppl_peaked']['q4']:.4f}; "
        f"launches {launches['quality_eval']}")
    lq = launches["quality_eval"]
    if not (all(np.isfinite(v) for v in flat) and lq["qmm"] and
            lq["decode_attn"] and lq["qmm_w4a8"] and lq["gptq"]
            and res["t_kld6"]["kld_mean"] < res["t_kld4"]["kld_mean"]):
        raise AssertionError(f"quality_eval {out['quality_eval']}")
    gc.collect()
    torch.cuda.empty_cache()

    # (e) bench_serving and decomp_flagship at their 7B defaults
    bs, _ = counted("bench_serving", quiet, bench_serving.main, [])
    out["bench_serving"] = {k: v for k, v in bs.items()}
    log(f"[scripts] bench_serving (7B, 16 jobs of 256 + 64 tokens) on "
        f"{card}: {bs['value']} tokens/s, TTFT p50 {bs['ttft_p50_ms']} ms, "
        f"p95 {bs['ttft_p95_ms']} ms; launches {launches['bench_serving']}")
    if len(bs["job_tokens"]) != 16 or not all(
            0 < n <= 64 for n in bs["job_tokens"].values()) or not (
            launches["bench_serving"]["qmm"]
            and launches["bench_serving"]["paged_decode_attn"]):
        raise AssertionError(f"bench_serving {bs}")
    gc.collect()
    torch.cuda.empty_cache()
    dc, lines = counted("decomp_flagship", quiet, decomp_flagship.main, [])
    for l in lines:
        log(f"[scripts] decomp_flagship: {l}")
    out["decomp_flagship"] = {
        "us": {k: t * 1e6 for k, (t, _) in dc["components"].items()},
        "gb_per_s": {k: b / t / 1e9
                     for k, (t, b) in dc["components"].items()},
        "mib": {k: b / 2 ** 20 for k, (_, b) in dc["components"].items()},
        "lm_head_us": dc["lm_head"][0] * 1e6,
        "lm_head_gb_per_s": dc["lm_head"][1] / dc["lm_head"][0] / 1e9,
        **{k: dc[k] for k in ("step_ms", "linears_ms", "head_ms",
                              "residue_ms", "weight_stream_bytes", "card",
                              "bound_ms")},
        "launches": launches["decomp_flagship"]}
    if not (dc["bound_ms"] and launches["decomp_flagship"]["qmm_w4a8"]
            and np.isfinite(dc["step_ms"])):
        raise AssertionError(f"decomp_flagship {out['decomp_flagship']}")
    gc.collect()
    torch.cuda.empty_cache()

    # (f) every example twin on the card; the greedy ones against the CPU
    files = {"image": os.path.join(OUT_DIR, "scripts_image.npy")}
    rng = np.random.default_rng(3)
    np.save(files["image"], (rng.random((16, 24, 3)) * 255).astype(np.uint8))
    files["qwen2"] = make_tiny_vlm(os.path.join(OUT_DIR, "scripts_qwen2"),
                                   "qwen2", head_scale=6.0)
    files["m4k"] = make_tiny_llama(os.path.join(OUT_DIR, "scripts_m4k"),
                                   quant="exl2", vocab=384, max_pos=4096,
                                   seed=5, head_scale=6.0)
    files["lora"] = write_random_lora(
        os.path.join(OUT_DIR, "scripts_lora"),
        Model.from_dir(TRAINED_TINY, device="cpu").weights, rank=4, seed=3)
    ex = {}
    for name in EXAMPLES:
        argv, stdin = example_argv(name, files)
        (r, lines, jobs) = counted(f"example_{name}", run_example, name,
                                   argv, stdin, dev)
        e = {"lines": len(lines), "jobs": len(jobs),
             "launches": launches[f"example_{name}"],
             "seconds": seconds[f"example_{name}"]}
        if not lines or not jobs:
            raise AssertionError(f"example {name}: {len(lines)} lines, "
                                 f"{len(jobs)} jobs")
        # inference_speculative (n-gram drafts on the fp16 fixture) runs
        # no hand kernel: dense linears, and its verify steps (t = 5)
        # attend through the gathered pool, as phase 12's n-gram leg
        if name != "inference_speculative" and not (
                e["launches"]["qmm"] or e["launches"]["paged_decode_attn"]):
            raise AssertionError(f"example {name}: no kernel launched "
                                 f"{e['launches']}")
        if name in GREEDY_EXAMPLES:
            _, cpu_lines, cpu_jobs = run_example(name, argv, stdin, "cpu")
            e["same_text"] = [l for l in lines if "t/s" not in l] == \
                [l for l in cpu_lines if "t/s" not in l]
            e["parts"] = []
            if job_tokens(jobs) != job_tokens(cpu_jobs):
                # run both again with every step's logits (one-token
                # steps) and hold the parting to a near-tie
                _, _, jl = run_example(name, argv, stdin, dev, True)
                _, _, cl = run_example(name, argv, stdin, "cpu", True)
                e["parts"] = jobs_agree(f"example {name}", jl, cl)
                e["parts_bursts"] = [
                    k for k, (a, b) in enumerate(zip(job_tokens(jobs),
                                                     job_tokens(cpu_jobs)))
                    if a != b]
        ex[name] = e
    out["examples"] = ex
    log(f"[scripts] the sixteen example twins on {card}: " + "; ".join(
        f"{n} {e['jobs']} jobs {e['seconds']:.1f} s launches "
        f"{e['launches']['qmm']}/{e['launches']['paged_decode_attn']}"
        + (f" greedy = CPU text {e['same_text']} parts {e['parts']}"
           if "parts" in e else "") for n, e in ex.items()))
    out["launches"] = {f"scripts_{k}": v for k, v in launches.items()}
    out["seconds_by_step"] = seconds
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] phase 18: {out['seconds']:.1f} s")
    return out


def g1_entry(conv, rate) -> dict:
    """The kernels-line entry of G1: one Llama-2-7B layer's 1,112 groups at
    4 bits, gs 32 (q, k, v, o, gate, up, down), from the per-shape rows of
    phase 15a; `launches` the count of phase 15b's conversion."""
    rows = {(r["k"], r["n"]): r for r in conv["g1"]["rows"] if r["gs"] == 32}

    def tot(key):
        return sum(c * rows[s][key] for s, c in G1_LAYER.items())

    return {"name": "gptq_rows", "route": "cuda",
            "source": "exllamav2_tpu_torch/csrc/gptq.cu",
            "replaces": "exllamav2_tpu/convert/gptq.py:202",
            "launches": conv["g1_launches"],
            "max_abs_err": conv["g1"]["max_abs_err"],
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bytes") / rate * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "unit": "one Llama-2-7B layer's 1,112 GPTQ groups, 4 bits, gs 32",
            "design": "a thread a column, the group's rows in registers, "
                      "U's block in shared memory: one launch a group (no "
                      "Pallas kernel: the reference's fori_loop)"}


def gated_entry(archs, rate) -> dict:
    """The kernels-line entry of kernel 1's gated launch: one Mixtral
    batch-1 decode token's expert launches (routed ones at m = 1 with
    their flag on, the others off), from the gate rows of phase 13."""
    mx = archs["mixtral"]
    on = mx["routed_per_layer"]["b1"]
    off = MIXTRAL["moe"] - on
    layers = MIXTRAL["layers"]

    def tot(key):
        s = 0.0
        for r in archs["gate_rows"]:
            if r["m"] != 1:
                continue
            mult = (2 if r["k"] == 4096 else 1) * (on if r["on"] else off)
            s += mult * (r[key] or 0.0)
        return layers * s

    return {"name": "qmm_fused_segment_matmul_gated", "route": "cuda",
            "source": "exllamav2_tpu_torch/csrc/qmm.cu",
            "replaces": "exllamav2_tpu/ops/qmm.py:437",
            "launches": archs["gated_launches_b1"],
            "launches_by_path": {p: c["qmm_gated"]
                                 for p, c in archs["launches"].items()},
            "max_abs_err": archs["gate_err"],
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bytes") / rate * 1e3, "bound_by": "bytes",
            # torch.matmul on the bf16 expert weight for the launches whose
            # flag is on (an off launch computes zeros: no library call)
            "library_ms": tot("library_ms"),
            "design": "kernel 1 with an int32 device flag read before the "
                      "first load: 0 writes zeros and streams no planes (the "
                      "reference's lax.cond around an expert, "
                      "exllamav2_tpu/models/forward.py:641)"}


def tools_entries(tools, rate) -> list:
    """The kernels-line entries of the tools path: each perf_qmm kernel
    summed over the three 7B shapes at M = 8, 4 bits, groups of 32 (the
    tool's defaults; nibble_i8 at its default tiles), and the ten probes
    summed into one entry with the per-probe numbers beside it."""
    out = []
    for name, line in (("perf_qmm_dma_only", "139"),
                       ("perf_qmm_gp_bf16", "177"),
                       ("perf_qmm_gp_int8", "177"),
                       ("perf_qmm_nibble_i8", "289")):
        sel = [r for r in tools["rows"] if r["kernel"] == name
               and r["gr"] in (0, TOOLS_GROUPS[0])]
        every = [r for r in tools["rows"] if r["kernel"].startswith(name)]
        out.append({
            "name": name, "route": "cuda",
            "source": "exllamav2_tpu_torch/csrc/perf_qmm.cu",
            "replaces": "tools/perf_qmm.py:" + line,
            "launches": tools["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bytes"] for r in sel) / rate * 1e3,
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in sel),
            "plane_gb_per_s": sum(r["plane_bytes"] for r in sel)
            / sum(r["ms"] for r in sel) / 1e6})
        kernel = {
            "perf_qmm_nibble_i8": "int8 mma.sync.m16n8k32 on fragments from "
                                  "the masked words",
            "perf_qmm_gp_bf16": "bf16 mma.sync.m16n8k16 on fragments from "
                                "the strided words (a byte transpose of four "
                                "words a slot, 0x43 above each value less "
                                "136 in bf16x2)",
            "perf_qmm_gp_int8": "int8 mma.sync.m16n8k32 on fragments from "
                                "the strided words (a byte transpose of four "
                                "words a slot), the group sums of xq by an "
                                "mma against ones"}.get(name)
        if kernel:
            out[-1]["design"] = {
                "kernel": kernel + ", K split over a thread-block cluster "
                          "summed through distributed shared memory: one "
                          "launch",
                "tiles": {f"{r['k']}x{r['n']}": r["tiles"] for r in sel}}
    probes = tools["probes"]
    out.append({
        "name": "probe_features", "route": "cuda",
        "source": "exllamav2_tpu_torch/csrc/probe_features.cu",
        "replaces": "tools/probe_features.py:23",
        "launches": tools["launches"]["probe_features"],
        "probes": {n: p["result"] for n, p in probes.items()},
        "max_abs_err": max(p["max_abs_err"] for p in probes.values()),
        "ms": sum(p["ms"] for p in probes.values()),
        "plain_ms": sum(p["plain_ms"] for p in probes.values()),
        "bound_ms": sum(p["bound_ms"] for p in probes.values()),
        "bound_by": "bytes",
        # one call per probe where PyTorch has one (the two dots); the sum
        # would mix probes, so the per-probe numbers carry it
        "library_ms": None,
        "by_probe": {n: {k: p[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                     for n, p in probes.items()}})
    out[-1]["launch_floor_ms"] = tools["launch_floor_ms"]
    out[-1]["by_probe"]["bf16_dot_bf16_acc_f32"]["design"] = (
        "K split over the 8 warps of a block, A and B staged by cp.async, "
        "fragments by ldmatrix (.trans for B), warp tiles summed in shared "
        "memory in warp order: one launch")
    from exllamav2_tpu_torch.tools import probe_features as PF
    for name in ("int8_dot", "int4_dot", "int8_dot_batched"):
        a, b = PF.probe_tensors(name, "cpu")
        g = a.shape[0] if a.dim() == 3 else 1
        (m, k), n = a.shape[-2:], b.shape[-1] * (2 if name == "int4_dot"
                                                  else 1)
        nibbles = " (nibbles as 16 v, the sum shifted back)" \
            if name == "int4_dot" else ""
        out[-1]["by_probe"][name]["design"] = (
            f"int8 mma.sync.m16n8k32, a 16x32 output tile a block: "
            f"{-(-n // 32)}x{-(-m // 16)}x{g} blocks of "
            f"{PF.int8_dot_warps(k)} warps, two 32-row k-steps a warp, "
            f"the loads straight into the fragments, B by a byte transpose"
            f"{nibbles}, warp tiles summed in shared memory four columns "
            f"a thread (one warp: its registers stored): one launch")
    return out


def summarize(qrows, qerr, arows, aerr, prows, perr, partials, launches,
              rate):
    """One entry per kernel for the kernels line, each with the times of the
    launches one decode step of its main path makes. qmm and
    decode_attention: one batch-1 token (qmm: the 4-bit prescaled rows at
    m=1 weighted by PER_TOKEN; attn: 32 layers at past_len 255, 32/32
    heads), `launches` the count of the batch-1 path.
    paged_decode_attention: one serving16 decode step's 32 launches at bf16
    (16 rows of mean valid length 152), `launches` the count of the
    serving16 round. qmm_w4a8: one merged + W4A8 serving16 decode step (32
    layers of q|k|v, o, gate|up, down at m=16, GPTQ gs128 with compressed
    meta), `launches` the count of that round. qmm_partials: one batch-1
    token under QMM_PARTIALS=1 (GPTQ gs128 rows at m=1 weighted by
    PER_TOKEN), `launches` the count of that generate_greedy call.
    `launches_by_path` holds each main path's own count."""
    main = launches["generate_greedy_b1"]

    def by_path(key):
        return {p: c[key] for p, c in launches.items() if key in c}

    def tot(rows, key, weight):
        return sum(weight[(r["k"], r["n"])] * r[key] for r in rows)

    def entry(name, source, replaces, count_key, path, err, rows, weight):
        return {"name": name, "route": "cuda",
                "source": "exllamav2_tpu_torch/csrc/" + source,
                "replaces": "exllamav2_tpu/ops/" + replaces,
                "launches": launches[path][count_key],
                "launches_by_path": by_path(count_key), "max_abs_err": err,
                "ms": tot(rows, "ms", weight),
                "plain_ms": tot(rows, "plain_ms", weight),
                "bound_ms": tot(rows, "bytes", weight) / rate * 1e3,
                "bound_by": "bytes",
                "library_ms": tot(rows, "library_ms", weight)}

    sel = [r for r in qrows
           if r["kind"] == "exl2_4b_prescaled" and r["m"] == 1]
    w4a8_rows, w4a8_err = partials["w4a8"]
    part_rows, part_err = partials["partials"]
    sel4 = [r for r in w4a8_rows
            if r["kind"] == "gptq_gs128_bf16meta" and r["m"] == SERVE_JOBS]
    sel5 = [r for r in part_rows if r["m"] == 1]
    per_step = {shape: LAYERS for shape in MERGED_SHAPES}
    att = next(r for r in arows if r["b"] == 1 and r["hkv"] == 32
               and r["past_len"] == 255)
    srv = next(r for r in prows if r.get("serving"))
    return [
        entry("qmm_fused_segment_matmul", "qmm.cu", "qmm.py:437", "qmm",
              "generate_greedy_b1", max(qerr, partials["src_cols"][1]), sel,
              PER_TOKEN),
        {"name": "decode_attention", "route": "cuda",
         "source": "exllamav2_tpu_torch/csrc/decode_attn.cu",
         "replaces": "exllamav2_tpu/ops/decode_attn.py:32",
         "launches": main["decode_attn"],
         "launches_by_path": by_path("decode_attn"), "max_abs_err": aerr,
         "ms": LAYERS * att["ms"], "plain_ms": LAYERS * att["plain_ms"],
         "bound_ms": LAYERS * att["bytes"] / rate * 1e3, "bound_by": "bytes",
         "library_ms": LAYERS * att["library_ms"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "exllamav2_tpu_torch/csrc/paged_attn.cu",
         "replaces": "exllamav2_tpu/ops/paged_attn.py:80",
         "launches": launches["serving16"]["paged_decode_attn"],
         "launches_by_path": by_path("paged_decode_attn"),
         "max_abs_err": perr,
         "ms": LAYERS * srv["ms"], "plain_ms": LAYERS * srv["plain_ms"],
         "bound_ms": LAYERS * srv["bound_ms"], "bound_by": srv["bound_by"],
         "library_ms": LAYERS * srv["library_ms"],
         "design": "split over the sequence in a thread-block cluster that "
                   "shares its score maxima; merge in rank order",
         "splits": srv["splits"]},
        entry("qmm_w4a8_segment_matmul", "qmm_w4a8.cu", "qmm.py:276",
              "qmm_w4a8", "serving16_merged_w4a8", w4a8_err, sel4, per_step),
        dict(entry("qmm_partials_segment_matmul", "qmm_partials.cu",
                   "qmm.py:156", "qmm_partials",
                   "generate_greedy_b1_partials", part_err, sel5, PER_TOKEN),
             design="bf16 mma.sync tile, scale and zero on the group "
                    "partials, K split over a cluster: one device kernel"),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import exllamav2_tpu_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:2] == ["tp-rank"]:            # a rank of phase 17
        return tp_rank(*sys.argv[2:4])
    torch.backends.cuda.matmul.allow_tf32 = False      # plain versions in
    torch.backends.cudnn.allow_tf32 = False            # full f32
    dev = torch.device("cuda")
    card = card_line()
    rate = mem_rate(card)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | bound rate {rate / 1e12:.2f} TB/s")
    t_all = time.perf_counter()
    detail = {"card": card, "torch": torch.__version__}
    if sys.argv[1:] == ["gqa-paged"]:
        return gqa_paged(dev, rate)
    detail["build"] = phase_build()
    if sys.argv[1:] == ["qmm"]:
        _, qerr = phase_qmm(dev, rate)
        gen = torch.Generator(device=dev)
        gen.manual_seed(4321)
        _, serr = qmm_src_cols(dev, rate, gen)
        log(f"[done] build and fused dequant-matmul kernel checks passed in "
            f"{time.perf_counter() - t_all:.1f} s (max err "
            f"{max(qerr, serr):.2e})")
        return 0
    if sys.argv[1:] == ["attn"]:
        _, aerr = phase_attn(dev, rate)
        log(f"[done] build and decode-attention kernel checks passed in "
            f"{time.perf_counter() - t_all:.1f} s (max err {aerr:.2e})")
        return 0
    if sys.argv[1:] == ["paged"]:
        detail["paged"], perr = phase_paged(dev, rate)
        log(f"[done] build and paged kernel checks passed in "
            f"{time.perf_counter() - t_all:.1f} s (max err {perr:.2e})")
        return 0
    if sys.argv[1:] == ["w4a8"]:
        errs = {k: f"{e:.2e}"
                for k, (_, e) in phase_partials(dev, rate).items()}
        log(f"[done] build and W4A8 / scales-on-partials / merged-meta "
            f"kernel checks passed in {time.perf_counter() - t_all:.1f} s "
            f"(max err {errs})")
        return 0
    if sys.argv[1:] == ["tools"]:
        phase_tools(dev, rate)
        log(f"[done] build and the tools phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["constrained"]:
        phase_constrained(dev)
        log(f"[done] build and the constrained phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["spec"]:
        detail["spec"] = phase_spec(dev)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_spec.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        log(f"[done] build and the spec phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["dvp-seeds"]:
        print(json.dumps(dvp_seeds(dev)))
        return 0
    if sys.argv[1:] == ["archs"]:
        detail["archs"] = phase_archs(dev, rate)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_archs.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        log(f"[done] build and the architectures phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["vlm"]:
        detail["vlm"] = phase_vlm(dev, rate)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_vlm.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        log(f"[done] build and the vision-language phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["convert"]:
        detail["convert"] = phase_convert(dev, rate)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_convert.json"),
                  "w") as f:
            json.dump(detail, f, indent=1, default=str)
        log(f"[done] build and the converter phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["cli"]:
        detail["convert"] = phase_convert(dev, rate)
        detail["cli"] = phase_cli(dev, card)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_cli.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        log(f"[done] build and the converter and tools phases passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["tp"]:
        detail["tp"] = phase_tp(dev, rate)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_tp.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        log(f"[done] build and the multi-GPU phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["scripts"]:
        detail["scripts"] = phase_scripts(dev, card)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_scripts.json"),
                  "w") as f:
            json.dump(detail, f, indent=1, default=str)
        log(f"[done] build and the scripts phase passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    if sys.argv[1:] == ["merged"]:
        phase_merged(dev, rate, phase_serving(dev, rate))
        log(f"[done] build and the serving phases 7 and 9 passed in "
            f"{time.perf_counter() - t_all:.1f} s")
        return 0
    seconds = {"build": detail["build"]["seconds"]}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[time] phase {name}: {seconds[name]:.1f} s")
        return out

    detail["qmm"], qerr = timed("qmm", phase_qmm, dev, rate)
    detail["attn"], aerr = timed("attn", phase_attn, dev, rate)
    detail["load"] = timed("load", phase_load, dev)
    detail["7b"] = timed("7b", phase_7b, dev)
    detail["paged"], perr = timed("paged", phase_paged, dev, rate)
    detail["serving"] = timed("serving", phase_serving, dev, rate)
    partials = timed("partials", phase_partials, dev, rate)
    detail["partials"] = {k: rows for k, (rows, _) in partials.items()}
    detail["merged"] = timed("merged", phase_merged, dev, rate,
                             detail["serving"])
    detail["tools"] = timed("tools", phase_tools, dev, rate)
    detail["constrained"] = timed("constrained", phase_constrained, dev)
    detail["spec"] = timed("spec", phase_spec, dev)
    detail["archs"] = timed("archs", phase_archs, dev, rate)
    detail["vlm"] = timed("vlm", phase_vlm, dev, rate)
    detail["convert"] = timed("convert", phase_convert, dev, rate)
    detail["cli"] = timed("cli", phase_cli, dev, card)
    detail["tp"] = timed("tp", phase_tp, dev, rate)
    detail["scripts"] = timed("scripts", phase_scripts, dev, card)
    detail["phase_seconds"] = seconds
    launches = dict(detail["7b"]["launches"])
    launches["serving16"] = detail["serving"]["launches"]
    launches["serving16_merged_w4a8"] = detail["merged"]["launches"]
    launches["serving16_merged"] = detail["merged"]["merged_launches"]
    launches["generate_greedy_b1_partials"] = \
        detail["merged"]["partials_launches"]
    launches["serving16_constrained"] = detail["constrained"]["launches"]
    launches["tools"] = detail["tools"]["launches"]
    launches.update(detail["spec"]["launches"])
    launches.update(detail["archs"]["launches"])
    launches.update(detail["vlm"]["launches"])
    launches["convert_7b_8_layers"] = {
        "gptq": detail["convert"]["g1_launches"]}
    launches["convert_served_b1"] = detail["convert"]["serve"]["launches"]
    launches["cli_server_round"] = detail["cli"]["server"]["launches"]
    launches["cli_test_inference"] = \
        detail["cli"]["test_inference"]["launches"]
    launches.update(detail["tp"]["launches"])
    launches.update(detail["scripts"]["launches"])
    tp = detail["tp"]
    kernels = summarize(detail["qmm"], qerr, detail["attn"],
                        max(aerr, tp["attn_err"]), detail["paged"],
                        max(perr, tp["paged_err"]), partials, launches, rate)
    # kernels 2 and 3 at StarCoder-15B's 48 query heads on one KV head
    # (phase 17a: b 1, past 1500; b 16 bf16 at lengths up to 1500)
    for entry, row in (
            (kernels[1], next(r for r in tp["attn"] if r["b"] == 1
                              and r["hq"] == 48 and r["past_len"] == 1500)),
            (kernels[2], next(r for r in tp["paged"] if r["b"] == 16
                              and r["hq"] == 48 and r["kind"] == "bf16"))):
        entry["at_48_query_heads_per_kv_head"] = {
            k: row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                "template", "blocks", "splits")}
    # and at the grouped-query heads of phases 3, 6 and 17a: kernel 2 at
    # past 1500, kernel 3 over bf16 pages, each batch size
    for entry, rows in ((kernels[1], detail["attn"] + tp["attn"]),
                        (kernels[2], detail["paged"] + tp["paged"])):
        entry["at_gqa"] = {
            f"{r['hq']}/{r['hkv']} d{r['d']} b{r['b']}": {
                k: r.get(k) for k in ("ms", "library_ms", "bound_ms",
                                      "template", "splits")}
            for r in rows if r["hq"] > r["hkv"] and not r.get("serving")
            and not any(r.get(k) for k in ("softcap", "window", "cap", "win"))
            and r.get("past_len", 1500) == 1500
            and r.get("kind", "bf16") == "bf16"}
    kernels.insert(1, gated_entry(detail["archs"], rate))
    kernels += tools_entries(detail["tools"], rate)
    kernels.append(g1_entry(detail["convert"], rate))
    kernels[-1]["launches_by_path"] = {
        p: c["gptq"] for p, c in launches.items() if "gptq" in c}
    detail["kernels"] = kernels
    detail["seconds"] = time.perf_counter() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    log(f"[done] all phases passed in {detail['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
